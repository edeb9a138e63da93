"""The port's SyntheticLM (numpy only) against the JAX package's: the same
batches, byte for byte, for every input mode, seed, step and host slice."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.configs import get_config as jax_get_config
from repro.data.synthetic import SyntheticLM as JaxSyntheticLM
from repro_torch.configs import get_config
from repro_torch.data import SyntheticLM
from repro_torch.train.loss import IGNORE

MODES = {"tokens": {}, "embeds": {"input_mode": "embeds"},
         "tokens+vision": {"input_mode": "tokens+vision", "vision_tokens": 8}}


def _pair(mode):
    over = MODES[mode]
    return (jax_get_config("tacc-100m", smoke=True).smoke(**over),
            get_config("tacc-100m", smoke=True).smoke(**over))


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 1), (1234, 99)])
def test_batches_are_byte_identical_to_jax(mode, seed, step):
    jcfg, tcfg = _pair(mode)
    ours = SyntheticLM(tcfg, 4, 24, seed=seed).batch(step)
    theirs = JaxSyntheticLM(jcfg, 4, 24, seed=seed).batch(step)
    assert list(ours) == list(theirs)
    for k in ours:
        assert ours[k].dtype == theirs[k].dtype, k
        assert ours[k].tobytes() == theirs[k].tobytes(), k


@pytest.mark.parametrize("mode", ["tokens", "tokens+vision"])
def test_host_slices_match_jax_and_tile_the_global_batch(mode):
    """With n_hosts=2 each host's rows are JAX's, and the two slices are
    the global batch's rows in order."""
    jcfg, tcfg = _pair(mode)
    whole = SyntheticLM(tcfg, 6, 16, seed=5).batch(3)
    parts = []
    for host in range(2):
        ours = SyntheticLM(tcfg, 6, 16, seed=5, host_id=host,
                           n_hosts=2).batch(3)
        theirs = JaxSyntheticLM(jcfg, 6, 16, seed=5, host_id=host,
                                n_hosts=2).batch(3)
        for k in ours:
            assert ours[k].tobytes() == theirs[k].tobytes(), (host, k)
        parts.append(ours)
    # the token walk is sliced from the global batch; the vision patches
    # are drawn per host, as in JAX
    for k in ("tokens", "labels"):
        np.testing.assert_array_equal(
            np.concatenate([p[k] for p in parts]), whole[k])


def test_labels_are_the_next_tokens_and_vision_patches_are_ignored():
    _, tcfg = _pair("tokens+vision")
    b = SyntheticLM(tcfg, 2, 20, seed=1).batch(0)
    vt = tcfg.vision_tokens
    assert b["vision_embeds"].shape == (2, vt, tcfg.d_model)
    assert (b["labels"][:, :vt] == IGNORE).all()
    np.testing.assert_array_equal(b["labels"][:, vt:-1], b["tokens"][:, 1:])
    with pytest.raises(ValueError, match="does not split"):
        SyntheticLM(tcfg, 5, 8, n_hosts=2)
