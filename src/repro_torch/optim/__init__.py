from repro_torch.optim.optimizers import (adafactor, adamw, apply_updates,
                                          clip_by_global_norm, make_optimizer)
from repro_torch.optim.schedules import make_lr_schedule
