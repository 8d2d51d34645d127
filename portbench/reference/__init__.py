"""Plain PyTorch references of the benchmark's configurations.

They are written from the published architectures and the configuration
files, compute in float32 with TF32 off unless a :class:`Precision` says
otherwise, and import nothing of the port or of JAX: the comparison that
decides a run's ``correct`` holds the port's outputs against them.
"""
