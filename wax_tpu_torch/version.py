# Verbatim copy of wax_tpu/version.py. It imports no JAX, but importing it from there
# runs wax_tpu/__init__.py, which imports jax eagerly; so the port keeps its own
# copy. Keep the two in step.
__version__ = "0.2.0"

# Single-file snapshot format version (see wax_tpu/storage/format.py).
SNAPSHOT_FORMAT_VERSION = 1
