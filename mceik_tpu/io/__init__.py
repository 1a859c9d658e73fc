"""I/O layer (SURVEY.md §1 L5): JSON config round-trip with dotted CLI
overrides, checkpoint/resume of full sampler state. The HDF5/CSV dataset
loaders live in ``mceik_tpu.io.loaders`` (HDF5 needs h5py, imported on
first use)."""

from mceik_tpu.io.config_io import load_config, save_config, config_from_dict, apply_overrides  # noqa: F401
from mceik_tpu.io.checkpoint import save_checkpoint, load_checkpoint  # noqa: F401
