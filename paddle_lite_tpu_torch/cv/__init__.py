"""Host-side image preprocessing (port of ``paddle_lite_tpu/cv``)."""

from .preprocess import bgr_to_rgb, flip, nv_to_rgb, resize, rotate, to_tensor
