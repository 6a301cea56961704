"""The port's copy of the JAX package's lock-order declaration
(``lockspec``), which the runtime lock witness in ``core.testing`` reads.
The static analyzer itself is not copied: it scans the JAX package."""
