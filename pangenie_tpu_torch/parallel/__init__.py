"""Process-level work placement (single process only, for now)."""
