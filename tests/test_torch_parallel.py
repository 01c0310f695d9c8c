"""The port's parallel/ package on the CPU: twins of tests/test_parallel.py.

A mesh names the CPU several times (``make_mesh(devices=["cpu"] * 8)``), the
port's counterpart of the JAX tests' 8 virtual CPU devices. The predictors'
sharded batches give the no-mesh lines and features, and those equal the JAX
package's on the same weights; the sharded index is bit-identical at any shard
count and agrees with the JAX ``ShardedSimilarityIndex`` on one device;
Doc2Vec trains and infers over a mesh as on one device, bit for bit, and
within the JAX package's tolerance of its one-device and 8-device runs.
"""

import numpy as np
import pytest
import torch

from anime_illust_image_searcher_tpu.config import CCIPConfig as JCCIPConfig
from anime_illust_image_searcher_tpu.config import Doc2VecConfig as JDoc2VecConfig
from anime_illust_image_searcher_tpu.models.doc2vec import Doc2VecModel as JDoc2VecModel
from anime_illust_image_searcher_tpu.models import caformer as jc
from anime_illust_image_searcher_tpu.models import ccip as jccip
from anime_illust_image_searcher_tpu.models import tagger as jtagger
from anime_illust_image_searcher_tpu.models.ccip_weights import save_ccip_checkpoint
from anime_illust_image_searcher_tpu.models.eva02 import tiny_test_config as jtiny
from anime_illust_image_searcher_tpu.parallel import mesh as jmesh
from anime_illust_image_searcher_tpu.parallel.sharded_index import (
    ShardedSimilarityIndex as JShardedSimilarityIndex,
)
from anime_illust_image_searcher_tpu_torch.config import CCIPConfig, Doc2VecConfig, TaggerConfig
from anime_illust_image_searcher_tpu_torch.models import caformer as tc
from anime_illust_image_searcher_tpu_torch.models.ccip import CCIPPredictor
from anime_illust_image_searcher_tpu_torch.models import doc2vec as d2v
from anime_illust_image_searcher_tpu_torch.models.doc2vec import Doc2VecModel, Vocab
from anime_illust_image_searcher_tpu_torch.models.eva02 import tiny_test_config
from anime_illust_image_searcher_tpu_torch.models.tagger import TaggerPredictor
from anime_illust_image_searcher_tpu_torch.ops.fused_query import exact_top_k
from anime_illust_image_searcher_tpu_torch.ops.query_scores import matvecs
from anime_illust_image_searcher_tpu_torch.parallel import mesh as mesh_lib
from anime_illust_image_searcher_tpu_torch.parallel.mesh import (
    DATA_AXIS, MODEL_AXIS, PinnedStager, data_parallel_batch, gather_rows, make_mesh,
    pad_to_multiple, put_global, shard_rows,
)
from anime_illust_image_searcher_tpu_torch.parallel.sharded_index import (
    ShardedSimilarityIndex,
)
from test_torch_checkpoint import timm_state_dict, write_checkpoint
from test_torch_tagging_cli import JCFG

TINY = tiny_test_config()
CFG = TaggerConfig(batch_size=8, image_size=TINY.img_size)
ARGS = (0.3, True, 0.3, True)
CPU = torch.device("cpu")


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """torch on one thread while this module runs (the suite runs several
    worker processes at once)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def cpu_mesh(n: int):
    return make_mesh(devices=["cpu"] * n)


def unit_rows(rng, n, f):
    m = rng.standard_normal((n, f), dtype=np.float32)
    return m / np.linalg.norm(m, axis=1, keepdims=True)


# ------------------------------------------------------------------- predictors


@pytest.fixture(scope="module")
def tagger_ckpt(tmp_path_factory):
    return write_checkpoint(tmp_path_factory.mktemp("dp_tagger") / "ckpt", timm_state_dict(23))


def jax_probs_without_near_ties(jpred, imgs):
    """The JAX predictor's probabilities, after checking the precondition of
    equal lines across frameworks: no selected probability lies within 1e-5
    of another selected one or of its threshold."""
    probs, g_t, c_t = (np.asarray(a) for a in jpred.predict_device(imgs))
    for cat, thresh in ((jpred._general_idx_np, g_t), (jpred._character_idx_np, c_t)):
        for row, t in zip(probs[:, cat].astype(np.float64), thresh):
            assert np.abs(row - t).min() > 1e-5
            sel = np.sort(row[row > t])
            assert sel.size == 0 or np.diff(sel).min(initial=1.0) > 1e-5
    return probs


def test_dp_tagger_matches_single_device(tagger_ckpt):
    """Batch-sharded tagging over an 8-entry mesh writes the no-mesh lines and
    the JAX predictor's lines on the same checkpoint; each shard's
    probabilities are bit-equal to its block run alone with no mesh."""
    imgs = np.random.RandomState(0).randint(0, 255, (8, 56, 56, 3), dtype=np.uint8)
    jpred = jtagger.TaggerPredictor(config=JCFG, model_dir=tagger_ckpt, model_cfg=jtiny(),
                                    use_pallas=False)
    jprobs = jax_probs_without_near_ties(jpred, imgs)
    single = TaggerPredictor(CFG, model_dir=tagger_ckpt, model_cfg=TINY, device="cpu")
    dp = TaggerPredictor(CFG, model_dir=tagger_ckpt, model_cfg=TINY, device="cpu",
                         mesh=cpu_mesh(8))
    lines = dp.predict(imgs, *ARGS)
    assert lines == single.predict(imgs, *ARGS)
    assert lines == jpred.predict(imgs, *ARGS)
    probs = dp.predict_probs(imgs)
    np.testing.assert_allclose(probs, jprobs, rtol=0, atol=1e-5)
    for i in range(8):
        np.testing.assert_array_equal(probs[i:i + 1], single.predict_probs(imgs[i:i + 1]))
    assert dp.device == CPU and list(dp.replicated.replicas) == [CPU]
    # without a mesh the predictor's mesh is its device alone
    assert single.mesh.devices == [CPU] and list(single.replicated.replicas) == [CPU]


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_dp_tagger_replicas_on_distinct_devices(tagger_ckpt, quant):
    """``cpu`` and ``cpu:0`` are two mesh devices: the second gets a replica
    loaded from the first's state dict (int8 buffers included), and the
    lines and probabilities are those of the no-mesh predictor on each half."""
    cfg = TaggerConfig(batch_size=4, image_size=TINY.img_size, quant=quant)
    imgs = np.random.RandomState(1).randint(0, 255, (4, 56, 56, 3), dtype=np.uint8)
    single = TaggerPredictor(cfg, model_dir=tagger_ckpt, model_cfg=TINY, device="cpu")
    dp = TaggerPredictor(cfg, model_dir=tagger_ckpt, model_cfg=TINY, device="cpu",
                         mesh=make_mesh(devices=["cpu", "cpu:0"]))
    assert dp.predict(imgs, *ARGS) == single.predict(imgs, *ARGS)
    replicas = [r[0] for r in dp.replicated.replicas.values()]
    assert len(replicas) == 2 and replicas[0] is dp.model and replicas[1] is not dp.model
    for a, b in zip(replicas[0].state_dict().values(), replicas[1].state_dict().values()):
        assert torch.equal(a, b)
    probs = dp.predict_probs(imgs)
    for half in (slice(0, 2), slice(2, 4)):
        np.testing.assert_array_equal(probs[half], single.predict_probs(imgs[half]))
    probs_dev, g_t, c_t = dp.predict_device(imgs)
    assert probs_dev.shape == (4, TINY.num_classes) and g_t.shape == c_t.shape == (4,)


@pytest.fixture(scope="module")
def ccip_dir(tmp_path_factory):
    model_dir = str(tmp_path_factory.mktemp("dp_ccip") / "model")
    import jax

    params = jax.tree_util.tree_map(np.asarray, jc.init_params(jc.tiny_test_config(), seed=0,
                                                               use_pallas=False))
    save_ccip_checkpoint(model_dir, jc.tiny_test_config(), params)
    return model_dir


def test_dp_ccip_features_match_single_device(ccip_dir):
    """gen_cfeatures --data-parallel: batch-sharded CCIP extraction equals the
    no-mesh features (each shard bit for bit), and the JAX predictor's."""
    cfg = CCIPConfig(image_size=64, feature_dim=32, batch_size=8)
    imgs = np.random.RandomState(0).randint(0, 255, (8, 64, 64, 3), dtype=np.uint8)
    single = CCIPPredictor(cfg, model_cfg=tc.tiny_test_config(), model_dir=ccip_dir,
                           device="cpu")
    a = single.ccip_batch_extract_features(imgs)
    for mesh in (cpu_mesh(8), make_mesh(devices=["cpu", "cpu:0"])):
        dp = CCIPPredictor(cfg, model_cfg=tc.tiny_test_config(), model_dir=ccip_dir,
                           device="cpu", mesh=mesh)
        b = dp.ccip_batch_extract_features(imgs)
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5)
        m = 8 // mesh.shape[DATA_AXIS]
        for s in range(0, 8, m):
            np.testing.assert_array_equal(
                b[s:s + m], single.ccip_batch_extract_features(imgs[s:s + m]))
    assert len(dp.replicated.replicas) == 2
    jpred = jccip.CCIPPredictor(
        config=JCCIPConfig(image_size=64, feature_dim=32, batch_size=8),
        model_cfg=jc.tiny_test_config(), use_pallas=False, model_dir=ccip_dir)
    np.testing.assert_allclose(b, jpred.ccip_batch_extract_features(imgs), rtol=0, atol=1e-5)


@pytest.mark.parametrize("make", [
    lambda m: TaggerPredictor(CFG, model_cfg=TINY, device="cpu", mesh=m),
    lambda m: CCIPPredictor(CCIPConfig(image_size=64, feature_dim=32),
                            model_cfg=tc.tiny_test_config(), device="cpu", mesh=m),
], ids=["tagger", "ccip"])
def test_predictors_refuse_a_mesh_spanning_processes(make):
    mesh = cpu_mesh(2)
    mesh.world_size = 2
    with pytest.raises(ValueError, match="must be single-host"):
        make(mesh)


def test_batch_must_divide_by_the_data_axis():
    pred = TaggerPredictor(CFG, model_cfg=TINY, device="cpu", mesh=cpu_mesh(3))
    with pytest.raises(ValueError, match="8 rows do not split into 3"):
        pred.predict_probs(np.zeros((8, 56, 56, 3), np.uint8))


# --------------------------------------------------------------------- Doc2Vec

D2V_TRAIN_TOL = dict(rtol=1e-4, atol=1e-5)   # JAX's own dp-vs-one-device tolerance
D2V_INFER_TOL = dict(rtol=1e-5, atol=1e-7)


def d2v_corpus(n=40):
    """tests/test_parallel.py:354's corpus: two disjoint 10-tag pools."""
    rng = np.random.RandomState(5)
    pools = [[f"a{i}" for i in range(10)], [f"b{i}" for i in range(10)]]
    return [list(rng.choice(pools[i % 2], size=6, replace=False)) for i in range(n)]


D2V_CFG = dict(vector_size=24, epochs=8, max_doc_len=16, sample=0.0)


def test_dp_doc2vec_training_matches_single_device():
    """Twin of tests/test_parallel.py:354: batch 16 over CPU meshes of 2 and 8
    entries trains the one-device model bit for bit, and agrees with the JAX
    package's one-device and 8-device runs within JAX's tolerance."""
    corpus = d2v_corpus()
    cfg = Doc2VecConfig(**D2V_CFG)
    single = Doc2VecModel.train(corpus, cfg, batch_size=16, device="cpu")
    for n in (2, 8):
        mesh = cpu_mesh(n)
        dp = Doc2VecModel.train(corpus, cfg, batch_size=16, mesh=mesh)
        assert dp.mesh is mesh and dp.device == CPU
        np.testing.assert_array_equal(dp.docvecs, single.docvecs)
        np.testing.assert_array_equal(dp.syn1neg, single.syn1neg)
    jcfg = JDoc2VecConfig(**D2V_CFG)
    for jmodel in (JDoc2VecModel.train(corpus, jcfg, batch_size=16),
                   JDoc2VecModel.train(corpus, jcfg, batch_size=16,
                                       mesh=jmesh.make_mesh(n_data=8))):
        np.testing.assert_allclose(single.docvecs, jmodel.docvecs, **D2V_TRAIN_TOL)
        np.testing.assert_allclose(single.syn1neg, jmodel.syn1neg, **D2V_TRAIN_TOL)


@pytest.mark.parametrize("chunk_docs", [None, 5, 1], ids=["one_chunk", "chunks_of_5",
                                                         "chunks_of_1"])
def test_dp_doc2vec_inference_matches_single_device(monkeypatch, chunk_docs):
    """Twin of tests/test_parallel.py:402: on one JAX-trained model, the
    port's inference over meshes of 2, 3 and 8 entries is its one-device
    inference bit for bit, whether the 16 docs make one chunk, four (5, 5,
    5, 1: the second round over 3 shards has a short chunk and two empty
    shards) or sixteen, and within JAX's tolerance of JAX's scan-fused group
    inference on one device and on its 8-device mesh."""
    corpus = d2v_corpus()
    jcfg = JDoc2VecConfig(infer_epochs=8, **D2V_CFG)
    jmodel = JDoc2VecModel.train(corpus, jcfg, batch_size=16)
    ids = [[jmodel.vocab.token2id[t] for t in d] for d in corpus[:16]]
    want = [jmodel._infer_group_scan(ids, chunk=8, epochs=8, len_bucket=8)]
    jmodel.mesh = jmesh.make_mesh(n_data=8)
    jmodel._infer_cache.pop("device_consts", None)
    want.append(jmodel._infer_group_scan(ids, chunk=8, epochs=8, len_bucket=8))
    cfg = Doc2VecConfig(infer_epochs=8, **D2V_CFG)
    model = Doc2VecModel(cfg, Vocab.from_counts(jmodel.vocab.tokens, jmodel.vocab.counts, cfg),
                         jmodel.syn1neg, jmodel.docvecs, device="cpu")
    single = model.infer_vectors(corpus[:16])
    if chunk_docs:   # 6 tags: the 8-wide bucket, (8 x 6) draws of 24 floats a doc
        monkeypatch.setattr(d2v, "_INFER_CHUNK_BYTES", chunk_docs * 8 * 6 * 24 * 4)
    for n in (2, 3, 8):
        model.mesh = cpu_mesh(n)
        np.testing.assert_array_equal(model.infer_vectors(corpus[:16]), single)
    assert list(model._consts[1]) == [CPU]        # one copy of the tables a device
    for w in want:
        np.testing.assert_allclose(single, w, **D2V_INFER_TOL)


@pytest.mark.parametrize("kw, err, match", [
    (dict(batch_size=12, mesh=8), ValueError, "batch_size 12 must divide by the data axis 8"),
    (dict(batch_size=8, mesh=3), ValueError, "batch_size 8 must divide by the data axis 3"),
    (dict(batch_size=8, mesh=2, device="cuda"), ValueError, "does not match the mesh's cpu"),
], ids=["12_over_8", "8_over_3", "device_type"])
def test_dp_doc2vec_batch_must_divide_by_the_data_axis(kw, err, match):
    kw = dict(kw, mesh=cpu_mesh(kw["mesh"]))
    if kw.get("device") == "cuda" and not torch.cuda.is_available():
        match = "CUDA"
        err = RuntimeError
    with pytest.raises(err, match=match):
        Doc2VecModel.train(d2v_corpus(), Doc2VecConfig(**D2V_CFG), **kw)


# ----------------------------------------------------------------------- index


def test_sharded_index_matches_unsharded():
    rng = np.random.default_rng(0)
    matrix = unit_rows(rng, 103, 32)   # deliberately not divisible by 8
    q = matrix[17]
    idx = ShardedSimilarityIndex(matrix, cpu_mesh(8))
    assert idx.rows == 104 and [s.shape[0] for s in idx.shards] == [13] * 8
    scores = idx.scores(q)
    expected = matrix @ q
    np.testing.assert_allclose(scores, expected, rtol=1e-5, atol=1e-6)
    vals, ids = idx.top_k(q, k=10)
    order = np.argsort(-expected)[:10]
    np.testing.assert_array_equal(ids, order)
    np.testing.assert_allclose(vals, expected[order], rtol=1e-5)
    # the whole index: every real row back, no padding id
    vals, ids = idx.top_k(q, k=200)
    assert sorted(ids.tolist()) == list(range(103))
    # bit-equal to one unsharded matvecs + exact_top_k
    m = torch.from_numpy(matrix)
    one = matvecs(m, torch.from_numpy(q)[None])[0]
    np.testing.assert_array_equal(scores, one.numpy())
    v1, i1 = exact_top_k(one, 10)
    vals, ids = idx.top_k(q, k=10)
    np.testing.assert_array_equal(vals, v1.numpy())
    np.testing.assert_array_equal(ids, i1.numpy())


def test_sharded_index_1m_rows_shard_count_invariance():
    """Scale proof: a 1M-row sharded index is buildable and queryable, its
    top-k is bit-identical at 2 and 8 shards, matches numpy, and its ids equal
    the JAX ShardedSimilarityIndex's on one device (scores within 1e-6)."""
    rng = np.random.default_rng(0)
    n, f, k = 1_000_003, 32, 100   # deliberately not divisible by any mesh size
    matrix = unit_rows(rng, n, f)
    q = matrix[123_457]
    results = {}
    for n_data in (2, 8):
        idx = ShardedSimilarityIndex(matrix, cpu_mesh(n_data))
        results[n_data] = idx.top_k(q, k=k)
        del idx
    (v2, i2), (v8, i8) = results[2], results[8]
    np.testing.assert_array_equal(i2, i8)
    np.testing.assert_array_equal(v2, v8)    # same math, same bits

    scores = matrix @ q
    order = np.argsort(-scores, kind="stable")[:k]
    assert len(set(i8.tolist()) & set(order.tolist())) >= k - 1
    np.testing.assert_allclose(v8, scores[i8], rtol=1e-5, atol=1e-6)
    assert i8[0] == 123_457 and v8[0] > 0.999

    jv, ji = JShardedSimilarityIndex(matrix, jmesh.make_mesh(n_data=1)).top_k(q, k=k)
    np.testing.assert_array_equal(i8, ji)
    np.testing.assert_allclose(v8, jv, rtol=0, atol=1e-6)


def test_merge_keeps_the_lowest_id_first_across_a_shard_boundary():
    """Equal scores that straddle shard boundaries come out lowest id first,
    as lax.top_k orders ties over the unsharded rows."""
    rng = np.random.default_rng(3)
    matrix = unit_rows(rng, 16, 8) * 0.5
    q = unit_rows(rng, 1, 8)[0]
    tied = [3, 4, 7, 8, 11, 12]        # rows 3|4, 7|8 and 11|12 sit on boundaries at 4 shards
    matrix[tied] = q
    for n_data in (1, 2, 4, 8):
        vals, ids = ShardedSimilarityIndex(matrix, cpu_mesh(n_data)).top_k(q, k=8)
        assert ids[:6].tolist() == tied, (n_data, ids)
        assert len(set(vals[:6].tolist())) == 1 and vals[6] < vals[5]
    jv, ji = JShardedSimilarityIndex(matrix, jmesh.make_mesh(n_data=1)).top_k(q, k=8)
    assert ids.tolist() == ji.tolist()


# ------------------------------------------------------------------------ mesh


def test_put_global_and_shard_rows_single_process():
    """One process: put_global gives shard_rows' blocks, in order, on their
    devices; the leading axis must divide by the shard count."""
    mesh = cpu_mesh(8)
    arr = np.arange(64, dtype=np.float32).reshape(16, 4)
    a, b = put_global(arr, mesh), shard_rows(mesh, torch.from_numpy(arr), PinnedStager())
    assert len(a) == len(b) == 8
    for i, (x, y) in enumerate(zip(a, b)):
        assert x.device == y.device == CPU
        np.testing.assert_array_equal(x.numpy(), arr[2 * i:2 * i + 2])
        assert torch.equal(x, y)
    with pytest.raises(ValueError, match="do not split"):
        shard_rows(mesh, arr[:15], PinnedStager())
    # one block comes back as it is; more are concatenated in order
    assert gather_rows(b[:1], CPU) is b[0]
    assert torch.equal(gather_rows(b, CPU), torch.from_numpy(arr))
    padded, n = pad_to_multiple(arr[:15], 8)
    assert n == 15 and padded.shape == (16, 4) and not padded[15].any()
    # a mesh that is one of two processes keeps its half
    mesh.rank, mesh.world_size = 1, 2
    blocks = put_global(arr, mesh)
    np.testing.assert_array_equal(torch.cat(blocks).numpy(), arr[8:])


@pytest.mark.parametrize("n_data", [1, 2, 8])
@pytest.mark.parametrize("flip", [False, True], ids=["contiguous", "flipped"])
def test_shard_rows_of_a_numpy_batch_on_the_cpu(n_data, flip):
    """On a CPU mesh a numpy batch takes the pageable route, with its stager
    unused, a batch with a negative stride (an ``x[..., ::-1]`` flip) too:
    each block is the batch's rows in a copy of its own, and each block
    counts once as pageable; the stager holds nothing."""
    mesh = cpu_mesh(n_data)
    stager = PinnedStager()
    arr = np.arange(16 * 3 * 2, dtype=np.uint8).reshape(16, 3, 2)
    if flip:
        arr = arr[..., ::-1]
    mesh_lib.reset_uploads()
    blocks = shard_rows(mesh, arr, stager)
    assert mesh_lib.uploads == {"pinned": 0, "pageable": n_data}
    m = 16 // n_data
    for i, b in enumerate(blocks):
        assert b.device == CPU and b.dtype == torch.uint8
        np.testing.assert_array_equal(b.numpy(), arr[i * m:(i + 1) * m])
        assert not np.shares_memory(b.numpy(), arr)
    assert stager._slots == {}
    shard_rows(mesh, arr, stager)
    assert mesh_lib.uploads == {"pinned": 0, "pageable": 2 * n_data}
    mesh_lib.reset_uploads()
    assert mesh_lib.uploads == {"pinned": 0, "pageable": 0}


@pytest.mark.parametrize("flip", [False, True], ids=["contiguous", "flipped"])
def test_shard_rows_of_a_read_only_memory_map(tmp_path, flip):
    """A read-only memory map, or a negative-stride view of one, gives
    writable tensors that share no memory with it; writing them leaves the
    file as it was."""
    want = np.random.default_rng(4).integers(0, 256, (8, 5), dtype=np.uint8)
    want.tofile(tmp_path / "rows.u8")
    mm = np.memmap(tmp_path / "rows.u8", dtype=np.uint8, mode="r", shape=(8, 5))
    assert not mm.flags.writeable
    rows = mm[:, ::-1] if flip else mm
    blocks = shard_rows(cpu_mesh(2), rows, PinnedStager())
    for i, b in enumerate(blocks):
        assert not np.shares_memory(b.numpy(), mm)
        np.testing.assert_array_equal(b.numpy(), np.asarray(rows[4 * i:4 * i + 4]))
        b.fill_(0)
    np.testing.assert_array_equal(np.fromfile(tmp_path / "rows.u8", np.uint8).reshape(8, 5), want)


@pytest.mark.parametrize("make", [
    lambda: TaggerPredictor(CFG, model_cfg=TINY, device="cpu"),
    lambda: CCIPPredictor(CCIPConfig(image_size=64, feature_dim=32),
                          model_cfg=tc.tiny_test_config(), device="cpu"),
], ids=["tagger", "ccip"])
def test_a_flipped_batch_gives_the_outputs_of_its_contiguous_copy(make):
    """A uint8 batch with a negative stride (``x[..., ::-1]``, a BGR<->RGB
    flip) gives bit for bit the outputs of its ``np.ascontiguousarray``
    copy: the tagger's probabilities, CCIP's features."""
    pred = make()
    s = pred.config.image_size
    x = np.random.default_rng(8).integers(0, 256, (2, s, s, 3), dtype=np.uint8)[..., ::-1]
    assert x.strides[-1] < 0
    run = (pred.predict_probs if isinstance(pred, TaggerPredictor)
           else pred.ccip_batch_extract_features)
    np.testing.assert_array_equal(run(x), run(np.ascontiguousarray(x)))


@pytest.mark.parametrize("n_data", [1, 2])
def test_shard_rows_of_a_tensor_takes_no_staging(n_data):
    """A tensor batch is cut into views of its own rows on their device:
    nothing is staged, and each block counts as pageable."""
    stager = PinnedStager()
    x = torch.arange(24, dtype=torch.float32).reshape(8, 3)
    mesh_lib.reset_uploads()
    blocks = shard_rows(cpu_mesh(n_data), x, stager)
    m = 8 // n_data
    for i, b in enumerate(blocks):
        assert b.data_ptr() == x[i * m].data_ptr() and torch.equal(b, x[i * m:(i + 1) * m])
    assert stager._slots == {}
    assert mesh_lib.uploads == {"pinned": 0, "pageable": n_data}


@pytest.mark.parametrize("rank", [0, 1])
def test_put_global_is_unchanged_and_counts_no_upload(rank):
    """put_global keeps its blocks (a rank's in-order share, each a copy of
    its own) and leaves the upload counter alone: it loads artifacts, not
    batches."""
    mesh = cpu_mesh(2)
    mesh.rank, mesh.world_size = rank, 2
    arr = np.arange(32, dtype=np.float32).reshape(8, 4)
    mesh_lib.reset_uploads()
    blocks = put_global(arr, mesh)
    assert mesh_lib.uploads == {"pinned": 0, "pageable": 0}
    assert len(blocks) == 2
    for i, b in enumerate(blocks):
        first = 2 * (2 * rank + i)
        np.testing.assert_array_equal(b.numpy(), arr[first:first + 2])
        assert not np.shares_memory(b.numpy(), arr)


@pytest.mark.parametrize("kw, match", [
    (dict(n_data=0), "n_data>=1 and n_model>=1"),
    (dict(n_data=2, n_model=2), "no model axis"),
    (dict(n_data=5), "wants 5x1=5 devices, only 4 available"),
])
def test_make_mesh_errors(kw, match):
    with pytest.raises(ValueError, match=match):
        make_mesh(devices=["cpu"] * 4, **kw)


def test_make_mesh_shape_and_idle_print(capsys):
    mesh = make_mesh(devices=["cpu"] * 4)
    assert mesh.shape == {DATA_AXIS: 4, MODEL_AXIS: 1} and capsys.readouterr().out == ""
    assert (mesh.rank, mesh.world_size) == (0, 1)
    mesh = make_mesh(n_data=2, devices=["cpu"] * 5)
    assert mesh.devices == [CPU, CPU] and mesh.distinct_devices == [CPU]
    assert "using 2 of 5 devices (3 idle)" in capsys.readouterr().out
    assert [data_parallel_batch(mesh, b) for b in (1, 2, 3, 8)] == [2, 2, 4, 8]


@pytest.mark.parametrize("local_world, local_rank, want", [
    (None, None, [0, 1, 2, 3]),      # one process: every visible card
    ("1", "0", [0, 1, 2, 3]),
    ("4", "2", [2]),                 # torchrun, one process a card: its own
])
def test_make_mesh_defaults_to_this_process_cards(monkeypatch, local_world, local_rank, want):
    """Under a launcher that starts a process a card on one host, the default
    mesh is this rank's card alone, so that no two ranks share a card."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    for name, value in (("LOCAL_WORLD_SIZE", local_world), ("LOCAL_RANK", local_rank)):
        if value is None:
            monkeypatch.delenv(name, raising=False)
        else:
            monkeypatch.setenv(name, value)
    assert make_mesh().devices == [torch.device("cuda", i) for i in want]


def test_make_mesh_without_a_card_raises():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal on a machine without a card")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(devices=["cuda:0"])
