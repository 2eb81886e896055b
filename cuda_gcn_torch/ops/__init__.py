"""Operators of the port: the two kernel-backed adjacency halves (bsr, residual),
graphsum on top of them, and the plain tensor ops (matmul, dropout, loss, adam)."""
