"""dino: the L4SN spectral-norm feature network, the backbone of waifu2x's
``l1l4sn*`` losses (counterpart of ``nunif_tpu/dino``); importing the
package registers ``dino.l4sn_feature`` and ``dino.l4sn``."""
from .l4sn import L4SN, L4SNFeature, l4sn_feature_loss

__all__ = ["L4SN", "L4SNFeature", "l4sn_feature_loss"]
