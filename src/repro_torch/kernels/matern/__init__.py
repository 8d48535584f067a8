"""Matérn-5/2 ARD kernel-matrix kernel (level-0 GP surrogate)."""
