"""Image helpers (counterpart of `incubator_mxnet_tpu/image/`): the
array functions the transforms use.  The decoders, the Augmenters,
`ImageIter` and `image/detection.py` are not ported yet (ROADMAP.md)."""
from .image import (imresize, resize_short, fixed_crop, random_crop,
                    center_crop, color_normalize)

__all__ = ["imresize", "resize_short", "fixed_crop", "random_crop",
           "center_crop", "color_normalize"]
