"""BUIR runner: BaseRunner + the EMA momentum update of the target tables
after every optimizer step (port of rechorus_tpu/runners/buir.py).

Parity: reference src/helpers/BUIRRunner.py:36 (model._update_target()
after optimizer.step()). Overriding `_post_update` turns the packed lazy
lane off (`BaseRunner._packed_lane_ok`): the EMA reads the online tables
after each step, so they must stay current in the module, as the
three-table lane keeps them.
"""
from __future__ import annotations

from rechorus_tpu_torch import registry
from rechorus_tpu_torch.runners.base import BaseRunner


@registry.register_runner("BUIRRunner")
class BUIRRunner(BaseRunner):
    def _post_update(self, state):
        state.model.ema_update()
