"""Image decode, resize, augment and iterate (counterpart of
`incubator_mxnet_tpu/image/`): the port's own JPEG/PNG/BMP codecs
(`codec`), the array helpers, the Augmenters, `ImageIter` and the
detection augmenters and `ImageDetIter` (`detection`)."""
from .image import (imdecode, imresize, resize_short, fixed_crop,
                    random_crop, center_crop, color_normalize,
                    HorizontalFlipAug, ResizeAug, ForceResizeAug,
                    RandomCropAug, CenterCropAug, CastAug, ColorJitterAug,
                    BrightnessJitterAug, ContrastJitterAug,
                    SaturationJitterAug, NormalizeAug, CreateAugmenter,
                    Augmenter, ImageIter)
from .detection import (DetAugmenter, DetBorrowAug, DetHorizontalFlipAug,
                        DetRandomCropAug, CreateDetAugmenter, ImageDetIter)

__all__ = ["imdecode", "imresize", "resize_short", "fixed_crop",
           "random_crop", "center_crop", "color_normalize", "Augmenter",
           "HorizontalFlipAug", "ResizeAug", "ForceResizeAug",
           "RandomCropAug", "CenterCropAug", "CastAug", "ColorJitterAug",
           "BrightnessJitterAug", "ContrastJitterAug",
           "SaturationJitterAug", "NormalizeAug", "CreateAugmenter",
           "ImageIter", "DetAugmenter", "DetBorrowAug",
           "DetHorizontalFlipAug", "DetRandomCropAug", "CreateDetAugmenter",
           "ImageDetIter"]
