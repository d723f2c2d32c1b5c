"""Host utilities of the port: copies of the JAX package's jax-free
utils.sigproc (filterbank headers) and utils.log (logging, metrics)."""
