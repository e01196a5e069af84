"""Train step of the port (microbatching, remat, mixed precision)."""
