"""The port's MVStereoSystem against the JAX package's in the
event-matching modes (0: matches fused naively, 2: matches refined by the
depth LM and fused), on tests/test_torch_mvstereo.py's world and with its
checks and tolerances (its docstring), with tests/test_mvstereo.py's
event-matcher config (15x15 patches, the windows kernel K1 takes on the
card).
"""
import pytest

from esvo_tpu_torch.runtime.mvstereo import MVStereoMode
from test_torch_mvstereo import few_threads, run_pair, world  # noqa: F401


@pytest.mark.parametrize("mode", [MVStereoMode.PURE_EVENT_MATCHING,
                                  MVStereoMode.EM_PLUS_ESTIMATION],
                         ids=lambda m: m.name.lower())
def test_em_mode_matches_jax(world, mode):  # noqa: F811
    _, n_points = run_pair(world, mode)
    assert n_points > 50
