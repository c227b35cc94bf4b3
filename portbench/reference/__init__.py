"""Plain exact nearest neighbours: the reference that decides correct.

Imports torch and numpy only, never the program under test."""
