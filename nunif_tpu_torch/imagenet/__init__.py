"""imagenet classifiers (counterpart of ``nunif_tpu/imagenet/``): the
vgg11-bn and swin-t backbones whose features feed perceptual losses.
Training is not ported yet."""
from . import models  # noqa: F401  (registers imagenet.vgg11 and imagenet.swin_t)
