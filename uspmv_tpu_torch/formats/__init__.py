from .coo import MtxData
from .scs import ScsData, convert_to_scs, permute_scs_cols
