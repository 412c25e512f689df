"""The sharded LLM program for reduced yi-9b: prefill, one train step
and decode on a (2, 2) ("data", "model") mesh of 4 gloo processes against
the unsharded port and the reference (`tests/_torch_sharded.py`), and
its sequence-sharded cache layout, which the kernel route refuses."""

import pytest

pytest.importorskip("jax")

from _torch_sharded import (check_decode, check_prefill,  # noqa: E402
                            check_train, run)

ARCH = "yi_9b"


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return run(tmp_path_factory.mktemp("sharded"), ARCH, seed=10,
               seq_layouts=True)


def test_prefill_logits(results):
    check_prefill(*results)


def test_train_step(results):
    check_train(*results)


def test_decode_tokens(results):
    check_decode(*results)


def test_sequence_sharded_cache_decodes_and_kernel_refuses(results):
    check_decode(*results, seq_sharded=True)
