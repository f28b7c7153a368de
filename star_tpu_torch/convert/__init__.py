from .convert import convert_state_dict, load_params, nest, save_params
from .from_flax import from_flax, load_flax
from .unet_map import NameMap, controlled_unet_name_map, trunk_name_map
from . import layout
