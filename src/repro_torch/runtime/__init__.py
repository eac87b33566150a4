"""Device selection and numerics settings for the port."""
