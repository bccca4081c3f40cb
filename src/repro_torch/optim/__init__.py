from repro_torch.optim.adamw import (AdamWConfig, apply_updates,
                                    apply_updates_, init_state, lr_schedule)

__all__ = ["AdamWConfig", "apply_updates", "apply_updates_", "init_state",
           "lr_schedule"]
