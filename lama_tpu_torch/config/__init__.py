"""Config composition for the port's CLIs (a copy of lama_tpu.config)."""
from .compose import compose, load_yaml, save_config, with_overrides
from .node import resolve_interpolations, to_dict
