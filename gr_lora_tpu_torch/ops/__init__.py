"""Signal-processing ops and the hand-written kernel wrappers (imported
by module path; nothing here is loaded eagerly)."""
