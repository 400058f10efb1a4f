"""The prefix store behind --prefix-store (data/storage.py)."""
