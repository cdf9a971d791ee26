"""Plain torch ops: coordinate plumbing, conversions and SpMV paths."""
