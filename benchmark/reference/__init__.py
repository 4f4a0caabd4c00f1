"""Plain float64 references of the benchmark's configurations (NumPy and
SciPy only; nothing of the program is imported)."""
