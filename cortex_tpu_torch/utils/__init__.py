"""Device selection."""
