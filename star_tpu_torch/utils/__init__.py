from .device import resolve_device
from .logger import get_logger
from .seed import setup_seed
