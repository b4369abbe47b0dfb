from repro_torch.core.baselines.chameleon import ChameleonBaseline  # noqa: F401
from repro_torch.core.baselines.blazeit import BlazeItBaseline  # noqa: F401
from repro_torch.core.baselines.miris import MirisBaseline  # noqa: F401
