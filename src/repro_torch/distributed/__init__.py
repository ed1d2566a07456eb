"""Work over a device mesh: the app axis and the trial axis
(``appaxis``); for training, the activation-sharding context (``ctx``),
the sharding rules (``sharding``) and parameters and optimizer state
stored as shards (``spmd``)."""

from .appaxis import (Shard, app_axis_name, app_sharded_cached,
                      app_trial_axes, make_app_sharded,
                      make_app_trial_sharded, pad_app_axis)

__all__ = ["Shard", "app_axis_name", "app_trial_axes", "pad_app_axis",
           "make_app_sharded", "app_sharded_cached",
           "make_app_trial_sharded"]
