"""K4, the streaming add of scripts/perf_probe9.py, on the CPU: its plain
version against the script's XLA reference (jnp a + b + c in bf16), and its
CUDA source through the CPU stand-in of tests/cuda_emu/ against the plain
version, bit for bit. The script itself cannot be imported: it benchmarks
at import. On a GPU, K4 is held against its plain version by
tests/test_torch_gpu.py and chip_smoke.py."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from torch_cuda_emulation import compile_emulated
from bcosification_tpu_torch.ops.cuda import _build, launch_counts, reset_launch_counts
from bcosification_tpu_torch.ops.cuda import stream as k4

torch.set_num_threads(1)


def _arrays(shape, nin, seed):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(nin)]


def _bf16_bits(t: torch.Tensor) -> np.ndarray:
    return t.view(torch.int16).numpy()


@pytest.mark.parametrize("nin", [2, 3, 4])
def test_plain_matches_xla_bit_for_bit(nin):
    """Tolerance: exact. The script's reference is the jitted a + b + c;
    its fused HLO on the CPU converts each f32 sum back to bf16 before the
    next add (no f32 intermediate is kept), as the plain version and K4 do,
    so the bits agree."""
    arrays = _arrays((1024, 256), nin, nin)

    @jax.jit
    def xla_fn(*arrs):
        acc = arrs[0]
        for a in arrs[1:]:
            acc = acc + a
        return acc

    want = xla_fn(*(jnp.asarray(a).astype(jnp.bfloat16) for a in arrays))
    got = k4.stream_add_plain(*(torch.from_numpy(a).to(torch.bfloat16) for a in arrays))
    want_bits = np.asarray(want).view(np.int16)
    np.testing.assert_array_equal(_bf16_bits(got), want_bits)


def test_wrapper_on_cpu_is_the_plain_version_and_counts_nothing():
    xs = [torch.from_numpy(a).to(torch.bfloat16) for a in _arrays((37, 5), 3, 1)]
    reset_launch_counts()
    assert torch.equal(k4.stream_add(*xs), k4.stream_add_plain(*xs))
    assert launch_counts()["stream_add"] == 0


def test_wrapper_rejects_bad_operands():
    a = torch.zeros(8, 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="2 to 4"):
        k4.stream_add(a)
    with pytest.raises(TypeError, match="bfloat16"):
        k4.stream_add(a, a.float())
    with pytest.raises(ValueError, match="shape"):
        k4.stream_add(a, a[:4])
    with pytest.raises(ValueError, match="contiguous"):
        k4.stream_add(a, torch.zeros(4, 8, dtype=torch.bfloat16).t())


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    # two blocks at most, so the grid-stride loop takes several steps
    lib = compile_emulated([_build.CSRC / "stream_add.cu"], tmp_path_factory.mktemp("k4_emu"),
                           defines=("STREAM_ADD_MAX_BLOCKS=2",))
    lib.stream_add.argtypes = k4._ARGS
    return lib


@pytest.mark.parametrize("nin", [2, 3, 4])
@pytest.mark.parametrize("shape,offset", [((1024, 256), 0), ((37, 27), 0), ((64, 8), 1)],
                         ids=["whole-groups", "ragged-tail", "unaligned"])
def test_cuda_source_matches_plain_bit_for_bit(emulated, nin, shape, offset):
    n = int(np.prod(shape))
    xs = [torch.from_numpy(a).to(torch.bfloat16).flatten()[offset:]
          for a in _arrays((n + offset,), nin, 7)]
    out = torch.empty(n, dtype=torch.bfloat16)
    ptrs = [x.data_ptr() for x in xs] + [None] * (4 - nin)
    assert emulated.stream_add(nin, *ptrs, out.data_ptr(), n, None) == 0
    np.testing.assert_array_equal(_bf16_bits(out), _bf16_bits(k4.stream_add_plain(*xs)))
