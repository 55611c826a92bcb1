"""Device selection and synthetic test input."""
