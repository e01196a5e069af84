"""Hand-written Hopper kernels and the program specs they execute."""
