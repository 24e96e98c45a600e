from .code import PolarCode
from .encode import polar_encode
from .allocate import polar_allocate, polar_deallocate, pc_matrix
from . import rate_match as rate_matching
