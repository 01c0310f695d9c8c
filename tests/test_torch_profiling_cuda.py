"""The port's spans on the card's trace.

Marked ``cuda``: they skip without an NVIDIA card. This file imports neither
JAX nor the JAX package:

    python -m pytest tests/test_torch_profiling_cuda.py --noconftest -q
"""

import pytest
import torch

from anime_illust_image_searcher_tpu_torch.utils import profiling

LAUNCH_CALLS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the trace of the card's timeline")
    return torch.device("cuda")


@pytest.mark.cuda
def test_span_encloses_its_launches_and_stays_off_the_card_timeline(cuda):
    """The range holds every kernel launch of its body on the trace's clock,
    and puts no event of its own on the card's timeline, where a reader of
    the card's busy time would count it as work."""
    x = torch.ones(512, 512, device=cuda)
    torch.cuda.synchronize()
    profiling.clear()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with profiling.span("step.launch"):
            for _ in range(4):
                x = (x @ x) * 1e-3
        torch.cuda.synchronize()
    events = list(prof.profiler.kineto_results.events())
    card = [e for e in events if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert card, "the profiler traced nothing on the card"
    assert not [e.name() for e in card if e.name().startswith(profiling.PREFIX)]
    (rng,) = [e for e in events if e.name() == profiling.PREFIX + "step.launch"]
    launches = [e for e in events if e.name() in LAUNCH_CALLS]
    assert len(launches) >= 8
    end = rng.start_ns() + rng.duration_ns()
    assert all(rng.start_ns() <= e.start_ns() and e.start_ns() + e.duration_ns() <= end
               for e in launches)
    assert profiling.recorded()["step.launch"]["count"] == 1
