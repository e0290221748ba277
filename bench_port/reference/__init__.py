"""Plain references the benchmark judges the port against.

NumPy and plain PyTorch only: nothing here imports the measured package,
JAX, or anything the measured package made. The inputs (histories, data,
initial weights) come from the benchmark, which hands the same ones to
both sides.
"""
