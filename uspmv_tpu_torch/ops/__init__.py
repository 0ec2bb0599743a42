from .device_format import DeviceScs, build_device_scs
from .scs_spmv import spmv_scs, spmv_scs_plain
