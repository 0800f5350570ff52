from .whisper import encode, decode, forward, init_cache, cross_kv  # noqa: F401
from .init import init_params, param_axes, sinusoidal_positions  # noqa: F401
from .load_hf import (load_params, params_from_state_dict,  # noqa: F401
                      save_pretrained, state_dict_from_params)
from .convert import params_from_numpy  # noqa: F401
