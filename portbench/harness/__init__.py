"""The cell-independent parts of the harness: finding a cell's files,
the run context, the device trace, the result line and the no-JAX check."""
