"""Device-resident stream buffering."""
