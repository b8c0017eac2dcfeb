"""Training of the port's LM, every architecture: AdamW with float32
master weights (:mod:`repro_torch.train.optimizer`) and the train steps,
baseline and int8-compressed across pods
(:mod:`repro_torch.train.train_step`)."""
