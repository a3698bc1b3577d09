"""PTQ calibration and quantization passes."""
