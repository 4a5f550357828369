"""Megatron-style sequence parallelism on the other families' placed
bodies on the CPU: recurrentgemma-9b's groups and tail layers, whisper's
encoder and decoder layers and mamba2-370m's layers under ``sp=True``,
each under (1, 2) and (2, 2) meshes of local rings at S 16, held against
the reference's unsharded step with the checks and tolerances of
``tests/test_torch_seq_parallel.py`` (whose helpers these tests run);
mamba2 at S 15 keeps the all-reduce path."""
import pytest

pytest.importorskip("torch")

from test_torch_seq_parallel import (check_indivisible,  # noqa: E402,F401
                                     check_sp_step, reference)

FAMILIES = ("recurrentgemma-9b", "whisper-medium", "mamba2-370m")


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("arch", FAMILIES)
def test_family_sp_step_matches_reference(reference, monkeypatch, arch,
                                          shape):
    check_sp_step(reference, monkeypatch, arch, shape)


def test_mamba2_indivisible_sequence_takes_the_all_reduce_path(
        reference, monkeypatch):
    check_indivisible(reference, monkeypatch, "mamba2-370m")
