"""The harness: what every cell shares."""
