from .mmio import read_mtx, write_mtx
from .generators import generate_matrix
