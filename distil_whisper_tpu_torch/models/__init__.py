from .whisper import encode, decode, init_cache, cross_kv  # noqa: F401
from .init import init_params, sinusoidal_positions  # noqa: F401
from .load_hf import load_params, params_from_state_dict  # noqa: F401
from .convert import params_from_numpy  # noqa: F401
