"""Model zoo: importing this package registers all components."""
from s4former_tpu_torch.models import backbones  # noqa: F401
from s4former_tpu_torch.models import decode_heads  # noqa: F401
from s4former_tpu_torch.models import losses  # noqa: F401
from s4former_tpu_torch.models import necks  # noqa: F401
from s4former_tpu_torch.models import segmentors  # noqa: F401
from s4former_tpu_torch.models.segmentors.encoder_decoder import build_segmentor  # noqa: F401
from s4former_tpu_torch.models.init_utils import init_segmentor_weights  # noqa: F401
