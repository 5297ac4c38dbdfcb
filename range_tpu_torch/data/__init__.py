"""Data helpers (numpy only)."""
