from repro_torch.train.trainer import Trainer, make_train_step

__all__ = ["Trainer", "make_train_step"]
