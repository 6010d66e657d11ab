from .train_loop import TrainState, create_train_state, make_train_step  # noqa: F401
