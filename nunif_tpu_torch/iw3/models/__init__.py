"""iw3 networks (counterpart of ``nunif_tpu/iw3/models``); importing the
package registers them."""
from .light_inpaint_v1 import LightInpaintV1  # noqa: F401  (inpaint.light_inpaint_v1)
from .mlbw import MLBW  # noqa: F401  (sbs.mlbw and sbs.mlbw_l2 ... mask_mlbw_l2)
from .row_flow_v2 import RowFlowV2  # noqa: F401  (sbs.row_flow_v2)
from .row_flow_v3 import RowFlowV3  # noqa: F401  (sbs.row_flow_v3)
from .light_video_inpaint_v1 import LightVideoInpaintV1  # noqa: F401  (inpaint.light_video_inpaint_v1*)
