"""Plain float32 PyTorch forms of the served models, written from the
published descriptions (and the conventions of the served weight tree),
independent of the program under test: nothing here imports the program,
its kernels or its plain versions.  The correctness check runs them on the
weights and prompts the benchmark made, and reads the program's answers
only to judge them."""
