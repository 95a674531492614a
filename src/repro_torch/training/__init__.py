"""Training substrate: optimizer, train step, sharding, data, compression."""

from .optimizer import OptConfig, opt_init, opt_update  # noqa: F401
from .train_step import init_train_state, make_loss, make_train_step  # noqa: F401
from .sharding import auto_demote, batch_spec, make_rules, state_shardings  # noqa: F401
from .data import DataConfig, SyntheticLM, make_batch_iterator  # noqa: F401
