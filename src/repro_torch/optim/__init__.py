from repro_torch.optim.adamw import AdamW, AdamWState, adamw  # noqa: F401
from repro_torch.optim.schedules import (cosine_schedule,  # noqa: F401
                                         linear_schedule)
from repro_torch.optim.clip import clip_by_global_norm, global_norm  # noqa: F401
