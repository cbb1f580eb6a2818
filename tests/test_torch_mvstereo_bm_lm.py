"""The port's MVStereoSystem against the JAX package's in mode 3
(BM_PLUS_ESTIMATION, the ESVO mapper: the SGM bootstrap, then block
matching refined by the depth LM and fused), on
tests/test_torch_mvstereo.py's world and with its checks and tolerances
(its docstring).
"""
from esvo_tpu_torch.runtime.mvstereo import MVStereoMode
from test_torch_mvstereo import few_threads, run_pair, world  # noqa: F401


def test_bm_plus_estimation_matches_jax(world):  # noqa: F811
    _, n_points = run_pair(world, MVStereoMode.BM_PLUS_ESTIMATION)
    assert n_points > 50
