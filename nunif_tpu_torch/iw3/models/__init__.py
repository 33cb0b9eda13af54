"""iw3 networks (counterpart of ``nunif_tpu/iw3/models``)."""
from .row_flow_v3 import RowFlowV3  # noqa: F401  (registers sbs.row_flow_v3)
