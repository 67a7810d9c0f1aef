"""Port of repro.optim."""
from repro_torch.optim.adamw import (adamw_init, adamw_update, cosine_lr,
                                     clip_by_global_norm)

__all__ = ["adamw_init", "adamw_update", "cosine_lr", "clip_by_global_norm"]
