"""Operation and byte counts of the kernels and models, and the card's
peaks: the yardstick's arithmetic, kept with the benchmark so that a
change of the program cannot move it."""
