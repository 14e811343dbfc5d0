"""The parameter-server side of the port: the native summation engine, the
homogeneous fused store, admission and the sync gradient exchange."""
