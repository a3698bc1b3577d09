"""Graph passes: importing this package registers the MIR-analog pipeline."""

from . import fusion  # noqa: F401
from . import kernel_pick  # noqa: F401
from ..quant import quantize_pass  # noqa: F401  (precision_cast, quant_dequant_fuse)
