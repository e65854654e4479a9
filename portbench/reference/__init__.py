"""The plain reference: exact k-NN in plain PyTorch. It imports nothing of
the port and nothing of JAX, and takes only the rows and queries that the
benchmark made."""
