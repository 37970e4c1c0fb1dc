"""The plain float32 reference the benchmark holds the program to."""
