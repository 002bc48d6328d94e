"""Vendored reference hasher constant tables (see tools/gen_hasher_tables.py)."""
