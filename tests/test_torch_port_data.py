"""The port's latent data loaders (data/{npy_table,native_loader,
cod_latent,latent_seq_packing,prefetch,s3_cod_latent,s3_cod_latent_mixed,
__init__}.py) against the JAX package, on the CPU; the spec is
tests/test_data.py, test_native_loader.py, test_prefetch.py and
test_s3_loader.py.

Every case writes its own npy table or tar in tmp_path from a numpy seed
and feeds both packages. Batches, windows, shuffles, packing spans and
doc_ids are held bit-equal (the same numpy arithmetic on the same
bytes); the packed training step's loss rtol 1e-5 and gradients atol
1e-5 / rtol 1e-3 (float32 reassociation), as tests/test_torch_port_train.py.
The S3 loaders run against a fake ``boto3`` kept here (boto3 is not
installed), as tests/test_s3_loader.py does.
"""

import io
import os
import random
import sys
import tarfile
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from owl_audio_exps_tpu.configs import transformer_config as jax_config
from owl_audio_exps_tpu.data import get_loader as jax_get_loader
from owl_audio_exps_tpu.data import native_loader as jax_native
from owl_audio_exps_tpu.data import s3_cod_latent as jax_s3
from owl_audio_exps_tpu.data.cod_latent import \
    WindowedViewDataset as JaxWindowed
from owl_audio_exps_tpu.data.latent_seq_packing import \
    PackedSequenceDataset as JaxPacked
from owl_audio_exps_tpu.data.npy_table import NpyTable as JaxTable
from owl_audio_exps_tpu.models.gamerft import GameRFT as JaxGameRFT
from owl_audio_exps_tpu_torch.configs import Config
from owl_audio_exps_tpu_torch.data import get_loader
from owl_audio_exps_tpu_torch.data import native_loader, s3_cod_latent
from owl_audio_exps_tpu_torch.data.cod_latent import WindowedViewDataset
from owl_audio_exps_tpu_torch.data.latent_seq_packing import \
    PackedSequenceDataset
from owl_audio_exps_tpu_torch.data.npy_table import NpyTable
from owl_audio_exps_tpu_torch.data.prefetch import device_prefetch
from owl_audio_exps_tpu_torch.models.gamerft import GameRFT
from owl_audio_exps_tpu_torch.nn.attn import attention_route
from owl_audio_exps_tpu_torch.ops import _build, splash
from owl_audio_exps_tpu_torch.parallel import mesh as port_mesh
from owl_audio_exps_tpu_torch.trainers import get_trainer_cls
from owl_audio_exps_tpu_torch.utils.weights import params_from_jax

from torch_port_util import MODEL_RNGS, carried, jax_core, numpy_params, t

COLUMNS = ["video", "mouse", "buttons", "tarball", "pt_idx", "missing",
           "truncated", "seq_len"]
ARRAYS = ["video", "mouse", "buttons"]


def make_table(path, table_cls=NpyTable, lens=(20, 17, 12), seed=0,
               dtype=np.float32, flags=None):
    """A table of documents of ``lens`` frames (4 x 2 x 2 latents, mouse,
    3 buttons) written by ``table_cls``; ``flags`` maps a row to
    (missing, truncated)."""
    table = table_cls(str(path), columns=COLUMNS, array_columns=ARRAYS)
    rs = np.random.RandomState(seed)
    for i, n in enumerate(lens):
        missing, truncated = (flags or {}).get(i, (False, False))
        table.append(video=rs.randn(n, 4, 2, 2).astype(dtype),
                     mouse=rs.randn(n, 2).astype(np.float32),
                     buttons=(rs.rand(n, 3) > 0.5).astype(np.float32),
                     tarball=f"t{i}", pt_idx=i, missing=missing,
                     truncated=truncated, seq_len=int(n))
    return table


def _equal_batches(a, b):
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


def _take(loader, n):
    it = iter(loader)
    return [next(it) for _ in range(n)]


# ----------------------------------------------------------------- table

@pytest.mark.parametrize("writer", ["jax", "port"])
def test_tables_read_across_packages(writer, tmp_path):
    write, read = (JaxTable, NpyTable) if writer == "jax" else \
        (NpyTable, JaxTable)
    make_table(tmp_path / "tbl", write, lens=(10, 7), dtype=np.float16,
               flags={1: (True, False)})
    want, got = JaxTable(str(tmp_path / "tbl")), read(str(tmp_path / "tbl"))
    assert got.columns == want.columns == COLUMNS
    assert got.array_columns == set(ARRAYS) and len(got) == 2
    assert got["seq_len"] == [10, 7] and got["missing"] == [False, True]
    for col in ARRAYS:
        for a, b in zip(got[col], want[col]):
            assert isinstance(a, np.memmap) and a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    # appending to a table the other package wrote keeps its schema
    with pytest.raises(ValueError, match="columns mismatch"):
        read(str(tmp_path / "tbl"), columns=["video"])


# -------------------------------------------------- windows and shuffles

@pytest.mark.parametrize("process_count", [1, 2])
def test_cod_batches_match_jax_over_two_epochs(process_count, tmp_path):
    """``cod`` through both registries: the same windows (missing rows
    dropped, truncated kept), the same epoch shuffles and the same
    process shards, bit for bit, over two epochs; the shards of the
    processes are disjoint and cover the windows."""
    make_table(tmp_path / "tbl", lens=(20, 17, 12, 9),
               flags={3: (True, False), 2: (False, True)})
    kw = dict(dataset_path=str(tmp_path / "tbl"), window_length=4,
              batch_columns=["video", "mouse", "buttons"])
    assert len(WindowedViewDataset(kw["dataset_path"], 4)) == 5 + 4 + 3
    seen = []
    for rank in range(process_count):
        port = get_loader("cod", 2, process_index=rank,
                          process_count=process_count, **kw)
        want = jax_get_loader("cod", 2, process_index=rank,
                              process_count=process_count, **kw)
        n_epoch = len(port._epoch_indices()) // 2
        batches = _take(port, 2 * n_epoch)
        for a, b in zip(batches, _take(want, 2 * n_epoch)):
            _equal_batches(a, b)
        assert batches[0][0].dtype == np.float32
        assert port.epoch == 1
        seen.append({int(i) for i in port._epoch_indices()})
    if process_count == 2:
        assert seen[0].isdisjoint(seen[1]) and len(seen[0] | seen[1]) == 12


def test_packing_spans_and_doc_ids_match_jax(tmp_path):
    make_table(tmp_path / "tbl", lens=(10, 7, 12, 5, 9))
    path = str(tmp_path / "tbl")
    port, want = PackedSequenceDataset(path, 6), JaxPacked(path, 6)
    assert len(port) == len(want) == 43 // 6
    for epoch in (0, 1, 2):
        port.set_epoch(epoch)
        want.set_epoch(epoch)
        assert port._slices == want._slices
        np.testing.assert_array_equal(port._row_lookup, want._row_lookup)
        for i in range(len(port)):
            a, b = port[i], want[i]
            assert set(a) == set(b) == set(ARRAYS) | {"doc_id"}
            assert a["doc_id"].dtype == np.int32
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    assert any(len(set(port[i]["doc_id"])) > 1 for i in range(len(port)))
    # through both registries at 1 and 2 processes, two epochs each
    kw = dict(dataset_path=path, window_length=6,
              batch_columns=["video", "mouse", "buttons"])
    for count in (1, 2):
        for rank in range(count):
            args = dict(process_index=rank, process_count=count, **kw)
            n = 2 * (len(port) // count)
            for a, b in zip(_take(get_loader("sequence_packing", 1, **args),
                                  n),
                            _take(jax_get_loader("sequence_packing", 1,
                                                 **args), n)):
                _equal_batches(a, b)
                assert len(a) == 4 and a[3].shape == (1, 6)
    with pytest.raises(ValueError, match="batch_size 1"):
        get_loader("sequence_packing", 2, **kw)


# --------------------------------------------------------- native gather

def test_native_gather_matches_plain_and_jax(tmp_path):
    """The port's native gather, built from its own csrc/owl_loader.cpp
    into build/ (never native/), byte-equal to its plain version and to
    the JAX package's gather; the dataset's batch path equals its items."""
    rs = np.random.RandomState(0)
    paths, offsets, arrays = [], [], []
    for i in range(3):
        arr = rs.randn(10, 4, 2).astype(np.float32)
        p = str(tmp_path / f"x{i}.npy")
        np.save(p, arr)
        off, dtype, shape = native_loader.npy_data_offset(p)
        assert (dtype, shape) == (np.float32, (10, 4, 2))
        paths.append(p)
        offsets.append(off)
        arrays.append(arr)
    starts, args = [2, 0, 6], (4, 4 * 2 * 4)
    got = native_loader.gather_windows(paths, starts, *args, offsets,
                                       np.dtype(np.float32), (4, 2))
    plain = native_loader.gather_windows(paths, starts, *args, offsets,
                                         np.dtype(np.float32), (4, 2),
                                         impl="plain")
    want = jax_native.gather_windows(paths, starts, *args, offsets,
                                     np.dtype(np.float32), (4, 2))
    assert got.shape == (3, 4, 4, 2)
    assert got.tobytes() == plain.tobytes() == want.tobytes()
    for i in range(3):
        np.testing.assert_array_equal(got[i], arrays[i][starts[i]:][:4])
    lib = native_loader.library_path()
    assert lib.exists() and lib.parent == _build.build_dir()
    with pytest.raises(IOError, match="item 0"):
        native_loader.gather_windows(paths[:1], [8], *args, offsets,
                                     np.dtype(np.float32), (4, 2))

    make_table(tmp_path / "tbl", lens=(12, 9))
    ds = WindowedViewDataset(str(tmp_path / "tbl"), window_length=4)
    idxs = list(range(len(ds)))
    batch = ds.batch(idxs, ["video", "mouse"])
    plain = ds.batch(idxs, ["video", "mouse"], impl="plain")
    jbatch = JaxWindowed(str(tmp_path / "tbl"), 4).batch(idxs,
                                                         ["video", "mouse"])
    for col in ("video", "mouse"):
        assert batch[col].tobytes() == plain[col].tobytes() \
            == jbatch[col].tobytes()
        for j, i in enumerate(idxs):
            np.testing.assert_array_equal(batch[col][j], ds[i][col])


def test_a_failed_native_build_raises(tmp_path, monkeypatch):
    broken = tmp_path / "owl_loader.cpp"
    broken.write_text("this is not C++\n")
    monkeypatch.setattr(native_loader, "SOURCE", broken)
    monkeypatch.setattr(native_loader, "_lib", None)
    monkeypatch.setattr(native_loader, "build_dir",
                        lambda: tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native_loader.gather_windows(["x"], [0], 1, 4, [0],
                                     np.dtype(np.float32), (1,))
    # nothing half written is left for another process to load
    assert not list((tmp_path / "build").glob("*"))


# -------------------------------------------------------------- prefetch

def test_prefetch_order_dtypes_errors_and_exhaustion():
    def gen(n=5):
        for i in range(n):
            yield [np.full((2, 2), float(i), np.float32),
                   np.full((2,), i, np.int32)]

    out = list(device_prefetch(gen(), "cpu"))
    assert len(out) == 5
    for i, (a, b) in enumerate(out):
        # arrays arrive as loaded: no cast, as the trainers need
        assert a.dtype == torch.float32 and b.dtype == torch.int32
        assert a[0, 0].item() == float(i) and b[0].item() == i

    def dies():
        yield [np.zeros(2, np.float32)]
        raise RuntimeError("loader died")

    it = device_prefetch(dies(), "cpu")
    next(it)
    with pytest.raises(RuntimeError, match="loader died"):
        next(it)
    assert len(list(device_prefetch(gen(3), "cpu", size=2))) == 3


def test_prefetch_joins_its_worker_when_the_consumer_stops():
    """Closing the stream joins the worker of an endless loader, so no
    daemon thread is left for the interpreter to stop inside a torch call
    at exit (which aborted 2-process gloo runs now and then)."""
    import itertools
    import threading

    def endless():
        for i in itertools.count():
            yield [np.full((2,), i, np.float32)]

    before = set(threading.enumerate())
    it = device_prefetch(endless(), "cpu")
    assert [next(it)[0][0].item() for _ in range(3)] == [0.0, 1.0, 2.0]
    assert len(set(threading.enumerate()) - before) == 1
    it.close()
    assert set(threading.enumerate()) - before == set()


# -------------------------------------------------------------------- S3

def _make_tar(n_frames=8, audio=False, controls=True,
              stems=("clip0", "clip1"), seed=0):
    gen = torch.Generator().manual_seed(seed)
    buf = io.BytesIO()
    with tarfile.open(fileobj=buf, mode="w") as tf:
        for stem in stems:
            members = [(".latent.pt", (n_frames, 4, 2, 2))]
            if controls:
                members += [(".mouse.pt", (n_frames, 2)),
                            (".buttons.pt", (n_frames, 3))]
            if audio:
                members += [(".audiolatent.pt", (n_frames, 6))]
            for suffix, shape in members:
                data = io.BytesIO()
                torch.save(torch.randn(*shape, generator=gen) * 5, data)
                info = tarfile.TarInfo(stem + suffix)
                info.size = data.getbuffer().nbytes
                data.seek(0)
                tf.addfile(info, data)
    return buf.getvalue()


def _bare_loader(module, **over):
    """An S3 loader of ``module`` without its boto3 client and threads."""
    loader = module.S3CoDLoader.__new__(module.S3CoDLoader)
    loader.queue = module.RandomizedQueue(max_size=100, seed=0)
    loader.window_length, loader.file_share_max = 4, 3
    loader.include_audio = loader.zero_controls = False
    loader.n_buttons, loader.n_mouse_axes = 3, 2
    loader._rng = random.Random(4242)
    for k, v in over.items():
        setattr(loader, k, v)
    return loader


def _drain(q):
    return [q.get() for _ in range(q.qsize())]


@pytest.mark.parametrize("case", [
    dict(), dict(file_share_max=2), dict(include_audio=True,
                                         zero_controls=True)])
def test_s3_unpacking_matches_jax(case):
    """The same tar unpacked by both packages' loaders (same seeds): the
    same windows in the same order, bit for bit; clamp to [-8, 8],
    ``file_share_max`` windows a file, zeroed controls, the audio member."""
    tar = _make_tar(16 if "file_share_max" in case else 8,
                    audio=case.get("include_audio", False),
                    controls=not case.get("zero_controls", False))
    got, want = (_bare_loader(m, **case) for m in (s3_cod_latent, jax_s3))
    got._unpack_tar(tar)
    want._unpack_tar(tar)
    items = _drain(got.queue)
    for a, b in zip(items, _drain(want.queue)):
        _equal_batches(a, b)
    # min(file_share_max, frames // window) windows from each of 2 clips
    assert len(items) == 4
    vid = items[0][0]
    assert vid.shape == (4, 4, 2, 2) and np.abs(vid).max() <= 8.0
    if case.get("zero_controls"):
        assert items[0][3].shape == (4, 6)
        assert not items[0][1].any() and not items[0][2].any()


class _FakeS3Client:
    """A bucket in a dict: the list_objects_v2 paginator and
    download_fileobj, standing in for boto3's client."""

    def __init__(self, objects):
        self.objects = objects

    def get_paginator(self, op):
        assert op == "list_objects_v2"
        objects = self.objects

        class _Pages:
            def paginate(self, Bucket, Prefix=""):
                yield {"Contents": [{"Key": k} for k in sorted(objects)
                                    if k.startswith(Prefix)]}

        return _Pages()

    def download_fileobj(self, bucket, key, buf):
        buf.write(self.objects[key])


@pytest.fixture
def fake_boto3(monkeypatch):
    objects = {}
    mod = types.ModuleType("boto3")
    mod.client = lambda service: _FakeS3Client(objects)
    monkeypatch.setitem(sys.modules, "boto3", mod)
    return objects


def test_s3_loaders_through_the_registry(fake_boto3):
    """``cod_s3_audio`` and ``cod_s3_mixed`` end to end through a fake
    client, incl. the startup barrier and the AV column order."""
    fake_boto3["av/part0.tar"] = _make_tar(audio=True)
    fake_boto3["av/skip.txt"] = b"not a tar"
    fake_boto3["labelled/a.tar"] = _make_tar(audio=True, seed=1)
    fake_boto3["unlabelled/b.tar"] = _make_tar(audio=True, controls=False,
                                               seed=2)
    loader = get_loader("cod_s3_audio", 2, bucket_name="bucket",
                        prefix="av/", window_length=4, file_share_max=3,
                        include_audio=True, n_buttons=3)
    loader.sleep_until_queues_filled()
    vid, aud, mouse, btn = next(iter(loader))
    assert (vid.shape, aud.shape, mouse.shape, btn.shape) == (
        (2, 4, 4, 2, 2), (2, 4, 6), (2, 4, 2), (2, 4, 3))
    assert vid.dtype == np.float32
    mixed = get_loader("cod_s3_mixed", 6, bucket_name="bucket",
                       labelled_prefix="labelled/",
                       unlabelled_prefix="unlabelled/", window_length=4,
                       n_buttons=3)
    mixed.sleep_until_queues_filled()
    vid, aud, mouse, btn, flags = next(iter(mixed))
    assert vid.shape == (6, 4, 4, 2, 2) and flags.dtype == bool
    for i in range(6):
        if not flags[i]:
            assert not mouse[i].any() and not btn[i].any()


def test_s3_loaders_need_boto3(monkeypatch):
    monkeypatch.setitem(sys.modules, "boto3", None)
    for data_id in ("cod_s3", "cod_s3_audio", "cod_s3_mixed"):
        with pytest.raises(ImportError, match="boto3"):
            get_loader(data_id, 1, bucket_name="bucket")
        with pytest.raises(ImportError, match="boto3"):
            jax_get_loader(data_id, 1, bucket_name="bucket")


# -------------------------------------------- sharding over the data ranks

def test_loaders_shard_by_data_rank(tmp_path, monkeypatch):
    """The registry's defaults come from the port's mesh: two data ranks
    read disjoint windows, the two seq ranks of one data rank read the
    same ones, and one process reads what the JAX package reads; the
    trainers' data path takes the same defaults."""
    make_table(tmp_path / "tbl", lens=(20, 17, 12))
    kw = dict(dataset_path=str(tmp_path / "tbl"), window_length=4,
              batch_columns=["video"])

    def indices(**mesh):
        monkeypatch.setattr(port_mesh, "_MESH", port_mesh.Mesh(**mesh))
        return [int(i) for i in get_loader("cod", 1, **kw)._epoch_indices()]

    d0s0 = indices(data=2, seq=2, data_index=0, seq_index=0)
    d0s1 = indices(data=2, seq=2, data_index=0, seq_index=1)
    d1s0 = indices(data=2, seq=2, data_index=1, seq_index=0)
    assert d0s0 == d0s1 and set(d0s0).isdisjoint(d1s0)
    assert len(d0s0) + len(d1s0) == 12
    one = indices()
    assert one == [int(i) for i in jax_get_loader(
        "cod", 1, **kw)._epoch_indices()]
    assert len(one) == 12

    monkeypatch.setattr(port_mesh, "_MESH", port_mesh.Mesh(
        data=2, seq=1, data_index=1))
    trainer = get_trainer_cls("rft")(Config.from_dict({
        "model": {"model_id": "game_rft"},
        "train": {"data_id": "cod", "data_kwargs": kw}}), device="cpu")
    got = next(trainer.data_stream("cod", 1, kw))[0]
    want = get_loader("cod", 1, **kw)
    first = int(want._epoch_indices()[0])
    np.testing.assert_array_equal(got[0].numpy(),
                                  want.ds[first]["video"])
    assert d1s0[0] == first


# ------------------------------------------------------------ port cuts

def test_port_cuts_keep_loaders_that_can_read(tmp_path, monkeypatch):
    """configs/dit_v4.yml keeps ``sequence_packing`` and its ``cod`` eval
    loader where the table exists; a missing table and an S3 loader
    without boto3 are cut, each with its reason."""
    from owl_audio_exps_tpu_torch.train import port_cuts
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    make_table(tmp_path / "tbl", lens=(20,))
    cfg = Config.from_yaml(os.path.join(repo, "configs", "dit_v4.yml"))
    cfg.train.data_kwargs.dataset_path = str(tmp_path / "tbl")
    cfg.train.sample_data_kwargs.dataset_path = str(tmp_path / "tbl")
    assert port_cuts(cfg, 1) == []
    assert (cfg.train.data_id, cfg.train.sample_data_id) == (
        "sequence_packing", "cod")

    cfg = Config.from_yaml(os.path.join(repo, "configs", "dit_v4.yml"))
    cuts = port_cuts(cfg, 1)
    assert [c.split()[:4] for c in cuts] == [
        ["data_id", "'sequence_packing'", "->", "'synthetic_latent'"],
        ["sample_data_id", "'cod'", "->", "'synthetic_latent'"]]
    assert all("does not exist" in c for c in cuts)

    monkeypatch.setitem(sys.modules, "boto3", None)
    cfg = Config.from_yaml(os.path.join(repo, "configs",
                                        "av_v5_8x8_weak.yml"))
    cuts = port_cuts(cfg, 1)
    assert cfg.train.data_id == "synthetic_av"
    assert "boto3" in cuts[0]
    monkeypatch.setitem(sys.modules, "boto3", types.ModuleType("boto3"))
    cfg = Config.from_yaml(os.path.join(repo, "configs",
                                        "av_v5_8x8_weak.yml"))
    assert port_cuts(cfg, 1) == [] and cfg.train.data_id == "cod_s3_audio"


# ------------------------------------------------- a packed training step

PACKED = dict(model_id="game_rft", n_layers=2, n_heads=2, d_model=32,
              channels=4, sample_size=2, tokens_per_frame=4, n_frames=16,
              n_buttons=3, causal=True, uncond=False, rope_impl="motion",
              rope_ats_delta=2.0, local_window=2, global_window=None,
              cfg_prob=0.0)


def test_packed_step_matches_jax(tmp_path, monkeypatch):
    """``RFTTrainer`` reads a written packed table (a 16-frame window,
    L = 64, holding several documents) and its loss and gradients on the
    batch match the JAX model's on the JAX loader's batch, given the JAX
    model's draws. The port's layers route to K1 with the documents
    (``attn_impl: splash``, its plain version on the CPU; a doc_id bars
    the band); the JAX package takes its dense masks on the CPU."""
    make_table(tmp_path / "tbl", lens=(10, 7, 12, 5, 9, 6))
    kw = dict(dataset_path=str(tmp_path / "tbl"), window_length=16,
              batch_columns=["video", "mouse", "buttons"])
    raw = {"model": dict(PACKED, attn_impl="splash"),
           "train": dict(trainer_id="rft", data_id="sequence_packing",
                         data_kwargs=kw, target_batch_size=1, batch_size=1,
                         opt="AdamW", vae_scale=0.63,
                         checkpoint_dir=str(tmp_path / "ckpt"))}
    trainer = get_trainer_cls("rft")(Config.from_dict(raw), device="cpu")
    batch = next(trainer.data_stream("sequence_packing", 1, kw))
    jbatch = next(iter(jax_get_loader("sequence_packing", 1, **kw)))
    _equal_batches([b.numpy() for b in batch], jbatch)
    doc_id = batch[3]
    assert doc_id.dtype == torch.int32 and len(set(doc_id[0].tolist())) > 1
    pcfg = trainer.model_cfg
    assert attention_route(pcfg, True, 64, doc_id) == ("splash", None)

    jcfg = jax_config(**PACKED)
    jin = [jnp.asarray(a) for a in jbatch]
    jin[0] = (jin[0] / 0.63).astype(jnp.bfloat16)
    model, params = jax_core(JaxGameRFT, jcfg, *jin, rngs=MODEL_RNGS)
    rngs = {"noise": jax.random.key(5)}

    def loss_and_draw(p):
        out = model.apply(p, *jin, return_dict=True, rngs=rngs)
        return out["diffusion_loss"], out

    (jl, draw), jgrads = jax.jit(jax.value_and_grad(
        loss_and_draw, has_aux=True))(params)

    port = carried(GameRFT, pcfg, params)
    calls = []
    plain = splash.splash_attention_plain
    monkeypatch.setattr(splash, "splash_attention_plain",
                        lambda *a, **k: calls.append(a[6]) or plain(*a, **k))
    vid = (batch[0] / 0.63).to(torch.bfloat16)
    loss = port(vid, batch[1], batch[2], doc_id, ts=t(draw["ts"]),
                z=t(draw["z_video"]), has_controls=t(draw["cfg_mask"]))
    loss.backward()
    assert len(calls) == 2 and all(torch.equal(c, doc_id) for c in calls)
    np.testing.assert_allclose(loss.item(), float(jl), rtol=1e-5)
    want = params_from_jax(numpy_params(jgrads), 2)
    for name, p in port.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[name].numpy(),
                                   atol=1e-5, rtol=1e-3, err_msg=name)
