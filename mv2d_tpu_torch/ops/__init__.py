# the kernels' `mv2d` operators, which the wrappers of these modules call
from . import library  # noqa: F401
