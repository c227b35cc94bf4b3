"""Measuring tools of the port that run on a CUDA card (never imported by
the package itself)."""
