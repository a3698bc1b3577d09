"""Operator library: importing this package registers every op + kernel."""

from . import activation  # noqa: F401
from . import calib  # noqa: F401
from . import common  # noqa: F401
from . import detection  # noqa: F401
from . import elementwise  # noqa: F401
from . import fused  # noqa: F401
from . import manip  # noqa: F401
from . import nn  # noqa: F401
from . import sequence  # noqa: F401
from . import kernels  # noqa: F401  (registers the "cuda" impls)
