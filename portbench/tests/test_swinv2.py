"""The SwinV2 tagger cell (``tag.swinv2b.b256``): its counts at the published
shapes, its reference against the port at a tiny size, the harness's run of
the cell on the CPU with faults planted underneath (each turns ``correct``
false), and the kernel group file it adds, which leaves every kernel name of
the two older cells in its group."""

import dataclasses
import glob
import os
import shutil
import time

import numpy as np
import pytest
import torch

from portbench import flops, harness, trace, weights
from portbench.reference import swinv2 as ref
from portbench.tests.test_runs import FAULTS, _OneCall

CELL = "tag.swinv2b.b256"
SEED = 2 ** 31 + 13
TINY = {"config": {"model": {"img_size": 64, "embed_dim": 16, "depths": [2, 2, 2, 2],
                             "num_heads": [1, 2, 2, 4], "window_size": 4, "cpb_hidden": 32,
                             "num_classes": 64},
                   "labels": {"rating": 4, "general": 48, "character": 12},
                   # f32 at this size: the cell's limit is set from bf16 at the
                   # published widths, and 8 tiny blocks of 16-128 channels
                   # round bf16 to a larger logit gap than 24 wide ones do
                   "serve": {"batch_size": 8, "dtype": "float32"}},
        "traffic": {"images_per_pass": 32, "pool_images": 16, "warmup_images": 8,
                    "sample_per_batch": 2, "decode_workers": 2}}


def _config(over=None):
    return harness._merge(harness.load("configs", "wd-swinv2-tagger-v3.json"),
                          (over or {}).get("config", {}))


def _run(over, control=False):
    return harness.run_cell(CELL, SEED, 0.5, False, time.perf_counter(), device="cpu",
                            overrides=over, control=control, report=lambda *a, **k: None)


# ------------------------------------------------------------------- counts


def test_swinv2_base_counts():
    """130.78 GFLOP an image (120.87 in GEMMs, 9.76 in window attention, 0.15
    in the patch conv) and 98.03 M parameters with the 10,861-class head; 24
    attention calls, 44 window shift passes and 24 q/k/v preparations a
    forward."""
    cfg = _config()
    m = cfg["model"]
    mod = flops.module("swinv2")
    assert round(mod.gflop_per_image(m), 2) == 130.78
    by = {}
    for c in mod.forward_calls(m, 1):
        by[c.group] = by.get(c.group, 0.0) + c.flops / 1e9
    assert (round(by["gemm"], 2), round(by["attention"], 2), round(by["conv"], 2)) \
        == (120.87, 9.76, 0.15)
    assert round(ref.parameter_count(cfg) / 1e6, 2) == 98.03
    calls = mod.forward_calls(m, 256)
    assert sum(c.group == "attention" for c in calls) == 24
    assert sum(c.group == "window" for c in calls) == 44 + 24
    # stage 1's window pass at B=256: 822 MB read and written, bf16; then its
    # q/k/v preparation, three times that
    a = 256 * 112 * 112 * 128 * 2
    assert calls[1].group == "window" and calls[1].nbytes == 2 * a
    assert calls[4].group == "window" and calls[4].nbytes == 6 * a


# ---------------------------------------------------------------- reference


def test_reference_leaves_load_into_the_port(tmp_path):
    """The seeded leaves, written as the cell writes its checkpoint, load
    through the port's loader, and the f32 port matches the reference."""
    from anime_illust_image_searcher_tpu_torch.models import swinv2, tagger
    from anime_illust_image_searcher_tpu_torch.models.weights import load_tagger_checkpoint
    from portbench.drivers.tag_swinv2 import write_checkpoint

    cfg = _config(TINY)
    params = weights.draw(ref.leaves(cfg), 5, "cpu")
    names, cats = ref.labels(cfg, 5)
    ref.calibrate_head(params, cfg, cats)
    write_checkpoint(str(tmp_path), cfg, params, names, cats)
    state, mcfg, labels = load_tagger_checkpoint(str(tmp_path))
    assert isinstance(mcfg, swinv2.SwinV2Config) and labels.names == names
    model = swinv2.SwinV2(dataclasses.replace(mcfg, dtype=torch.float32), device="cpu")
    model.load_state_dict(state)
    imgs = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (3, 64, 64, 3), np.uint8))
    mean = torch.full((3,), 0.5)
    with torch.inference_mode():
        got = tagger._predict_probs(model.eval(), imgs, mean, mean)
    want = ref.probs({k: v.float() for k, v in params.items()}, cfg, imgs)
    assert torch.allclose(got, want, atol=2e-5, rtol=0), (got - want).abs().max()


# --------------------------------------------------------------------- runs


def test_sound_run_is_correct():
    r = _run(TINY)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert set(r["metrics"]) == {"tag_img_per_s", "setup_s"}


@pytest.mark.parametrize("fault", sorted(FAULTS) + ["one_later_batch"])
def test_fault_in_probabilities_is_caught(monkeypatch, fault):
    from anime_illust_image_searcher_tpu_torch.models import tagger

    real = tagger.TaggerPredictor._forward
    planted = FAULTS.get(fault) or _OneCall(4)

    def broken(self, images_u8, thresholds):
        probs, *rest = real(self, images_u8, thresholds)
        return (planted(probs), *rest)

    monkeypatch.setattr(tagger.TaggerPredictor, "_forward", broken)
    r = _run(TINY)
    assert r["checks"]["logit_rms"]["value"] > r["checks"]["logit_rms"]["limit"], r["checks"]


def test_fault_in_the_line_is_caught(monkeypatch):
    from anime_illust_image_searcher_tpu_torch.models import tagger

    real = tagger.TaggerPredictor._assemble_line
    monkeypatch.setattr(tagger.TaggerPredictor, "_assemble_line",
                        lambda self, *a: real(self, *a) + ",extra_tag")
    r = _run(TINY)
    assert not r["correct"] and r["checks"]["line_mismatch"]["value"] > 0


def test_int8_weights_are_caught(monkeypatch):
    """The port's own int8 Linears (ops/quant.Int8Linear) planted in the
    SwinV2 MLPs, as a change serving them in int8 would."""
    from anime_illust_image_searcher_tpu_torch.models import swinv2, tagger
    from anime_illust_image_searcher_tpu_torch.ops.quant import Int8Linear

    real = tagger.TaggerPredictor.load_model

    def load(self):
        real(self)
        for m in self.model.modules():
            if isinstance(m, swinv2.Mlp):
                for name in ("fc1", "fc2"):
                    lin = getattr(m, name)
                    if isinstance(lin, Int8Linear):
                        continue
                    q = Int8Linear(lin.in_features, lin.out_features, out_dtype=lin.weight.dtype)
                    q.set_weight(lin.weight.float())
                    q.bias.data.copy_(lin.bias.float())
                    setattr(m, name, q)

    monkeypatch.setattr(tagger.TaggerPredictor, "load_model", load)
    r = _run(TINY)
    assert not r["correct"] and r["checks"]["low_precision_tensors"]["value"] > 0


def test_control_reads_fp8():
    """The control puts the fp8 reference in the port's place: only the gap
    to f32 moves, and it moves past the sound run's."""
    sound, control = _run(TINY), _run(TINY, control=True)
    assert control["checks"]["logit_rms"]["value"] > 3 * sound["checks"]["logit_rms"]["value"]
    assert control["checks"]["line_mismatch"]["value"] == 0


# ----------------------------------------------------------- kernel groups

# every kernel name the two older cells' traces and breakdowns have shown
# (PERF.md sections 5-6, the ledger's breakdowns)
OLDER = [
    "void (anonymous namespace)::attn_fwd_wgmma<64>(unsigned long, Params)",
    "void (anonymous namespace)::attn_fwd_wgmma<32>(unsigned long, Params)",
    "conv2d_c1_k1_nhwc_specialized",
    "sm80_xmma_fprop_implicit_gemm_bf16bf16_bf16f32_f32_nhwckrsc_nhwc_s16816fprop",
    "void at::native::elementwise_kernel<128, 2, at::native::gpu_kernel_impl<...>>",
    "void at::native::elementwise_kernel<128, 4, at::native::gpu_kernel_impl<...>>",
    "void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda>",
    "void at::native::vectorized_elementwise_kernel<4, at::native::GeluCUDAKernelImpl>",
    "void at::native::vectorized_elementwise_kernel<8, at::native::CUDAFunctor_add<c10::BFloat16>>",
    "void at::native::_scatter_gather_elementwise_kernel<128, 8, ...>",
    "nvjet_tst_128x256_64x4_2x1_v_bz_coopA_bias_TNN",
    "nvjet_tst_144x192_64x5_1x2_h_bz_coopB_bias_TNN",
    "nvjet_tst_256x128_64x4_1x2_h_bz_coopA_bias_TNT",
    "cutlass_80_tensorop_bf16_s16816gemm_relu_bf16_64x64_64x4_tn_align2",
    "void at::native::(anonymous namespace)::LayerNormForwardCUDAKernel<float, float>",
    "void at::native::(anonymous namespace)::RowwiseMomentsCUDAKernel<float, float, false>",
    "void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float, float, false>",
    "void at::native::(anonymous namespace)::CatArrayBatchedCopy<...>",
    "Memcpy HtoD (Pageable -> Device)",
    "void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float, ...>>",
    "void at::native::radixSortKVInPlace<...>",
]


def test_kernel_groups_leave_the_older_cells_unchanged(tmp_path):
    base_dir = tmp_path / "groups"
    base_dir.mkdir()
    for path in glob.glob(os.path.join(harness.BENCH_DIR, "kernel_groups", "*.json")):
        if not os.path.basename(path).startswith("10_swinv2"):
            shutil.copy(path, base_dir)
    before = trace.KernelGroups(str(base_dir))
    after = trace.KernelGroups(os.path.join(harness.BENCH_DIR, "kernel_groups"))
    assert [after(n) for n in OLDER] == [before(n) for n in OLDER]
    assert after("fmha_cutlassF_bf16_aligned_64x64_rf_sm80(PyTorchMemEffAttention::"
                 "AttentionKernel<...>::Params)") == "attention"
    assert before("fmha_cutlassF_bf16_aligned_64x64_rf_sm80") == "gemm"
    assert after("cudnn_generated_fort_native_sdpa_sm90_knob_7_64x64x64_4x1x1_kernel0_0") \
        == "attention"
    assert after("void (anonymous namespace)::window_shift_partition_kernel<uint4>(...)") \
        == "window"
    assert after("void (anonymous namespace)::window_shift_reverse_kernel<uint4>(...)") \
        == "window"
    assert after("void (anonymous namespace)::window_qkv_unit_kernel<__nv_bfloat16>(...)") \
        == "window"
