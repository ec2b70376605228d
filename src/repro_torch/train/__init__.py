from repro_torch.train.loop import TrainConfig, Trainer, make_train_step  # noqa: F401
