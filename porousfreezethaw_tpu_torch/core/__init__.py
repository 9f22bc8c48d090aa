from .device import DeviceError, field_dtype, resolve_device
from .grid import GridGeometry
