from repro_torch.train.step import cross_entropy, make_train_step
