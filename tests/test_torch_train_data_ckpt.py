"""The port's data pipeline (`data/pipeline.py`) and checkpoint manager
(`ckpt/manager.py`) against the JAX reference's, on the CPU.

Batches from `SyntheticSource` and `MemmapSource` equal the reference's
element for element (shards, `batch_at`, the prefetch thread's order).
A checkpoint written by either package restores in the other, every
leaf bit for bit (bf16 through its uint16 view) and the manifests equal;
an async save survives an in-place update made right after it.
"""

import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.ckpt.manager import CheckpointManager as JCkpt  # noqa: E402
from repro.data import pipeline as jpipe  # noqa: E402
from repro_torch.ckpt.manager import CheckpointManager  # noqa: E402
from repro_torch.data import pipeline as tpipe  # noqa: E402
from repro_torch.tree import leaves_with_paths  # noqa: E402


def loaders(source_of, **cfg):
    return (tpipe.DataLoader(source_of(tpipe), tpipe.LoaderConfig(**cfg)),
            jpipe.DataLoader(source_of(jpipe), jpipe.LoaderConfig(**cfg)))


def equal_batches(a, b):
    assert sorted(a) == sorted(b) == ["targets", "tokens"]
    for k in a:
        assert a[k].dtype == b[k].dtype == np.int32
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("vocab,seed", [(512, 0), (50304, 3)])
def test_synthetic_sequences_equal_reference(vocab, seed):
    port, ref = tpipe.SyntheticSource(vocab, seed), jpipe.SyntheticSource(
        vocab, seed)
    for index, length in ((0, 16), (7, 64), (1234, 33)):
        np.testing.assert_array_equal(port.sequence(index, length),
                                      ref.sequence(index, length))


@pytest.mark.parametrize("shard", [0, 1])
def test_sharded_batches_equal_reference(shard):
    port, ref = loaders(lambda m: m.SyntheticSource(512, 1), batch_size=3,
                        seq_len=16, shard_id=shard, num_shards=2, seed=1)
    try:
        for step in (0, 1, 5):
            equal_batches(port.batch_at(step), ref.batch_at(step))
        # the prefetch thread's batches, in order
        for _ in range(3):
            equal_batches(next(port), next(ref))
    finally:
        port.close()
        ref.close()


def test_memmap_batches_equal_reference(tmp_path, rng):
    path = tmp_path / "tokens.bin"
    jpipe.MemmapSource.write(path, rng.integers(0, 50000, 4096))
    port, ref = loaders(lambda m: m.MemmapSource(path), batch_size=4,
                        seq_len=32)
    try:
        for step in (0, 3, 40):          # 40 wraps around the file
            equal_batches(port.batch_at(step), ref.batch_at(step))
        equal_batches(next(port), next(ref))
    finally:
        port.close()
        ref.close()


def tree_np(rng):
    """A train-state-like tree: bf16 and float32 parameters, int8
    moments with float32 scales, an int32 scalar count."""
    import ml_dtypes

    return {"params": {
                "embed": rng.normal(size=(8, 4)).astype(ml_dtypes.bfloat16),
                "layers": {"w": rng.normal(size=(2, 4, 3)).astype(np.float32)}},
            "opt": {"count": np.asarray(7, np.int32),
                    "m": {"embed": {
                        "q": rng.integers(-127, 128, (8, 4)).astype(np.int8),
                        "s": rng.random((8, 1)).astype(np.float32)}}}}


def to_torch(tree):
    return jax.tree.map(lambda a: torch.from_numpy(
        a.view(np.int16).copy()).view(torch.bfloat16)
        if a.dtype.name == "bfloat16" else torch.from_numpy(np.array(a)),
        tree)


def bits(x):
    """A leaf's raw bits as a numpy integer array."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        x = x.numpy()
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return x.view(np.int16)
    return x.view({1: np.int8, 4: np.int32}[x.dtype.itemsize])


def test_reference_checkpoint_restores_in_port(tmp_path, rng):
    tree = tree_np(rng)
    JCkpt(tmp_path).save(5, jax.tree.map(jnp.asarray, tree))
    like = to_torch(jax.tree.map(np.zeros_like, tree))
    got, step = CheckpointManager(tmp_path).restore(like=like, device="cpu")
    assert step == 5
    for (path, want), (_, g) in zip(leaves_with_paths(tree),
                                    leaves_with_paths(got)):
        assert g.dtype == like_leaf(like, path).dtype, path
        np.testing.assert_array_equal(bits(g), bits(want), err_msg=str(path))


def like_leaf(tree, path):
    for k in path:
        tree = tree[k]
    return tree


def test_port_checkpoint_restores_in_reference(tmp_path, rng):
    tree = tree_np(rng)
    CheckpointManager(tmp_path / "port").save(5, to_torch(tree))
    JCkpt(tmp_path / "ref").save(5, jax.tree.map(jnp.asarray, tree))
    port_dir, ref_dir = tmp_path / "port/step_00000005", \
        tmp_path / "ref/step_00000005"
    assert ((port_dir / "manifest.json").read_text()
            == (ref_dir / "manifest.json").read_text())
    meta = json.loads((port_dir / "manifest.json").read_text())
    assert meta["paths"][:2] == ["opt/count", "opt/m/embed/q"]
    assert meta["dtypes"][-2] == "bfloat16"
    for i in range(len(meta["paths"])):
        a = np.load(port_dir / f"leaf_{i:05d}.npy")
        b = np.load(ref_dir / f"leaf_{i:05d}.npy")
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    got, step = JCkpt(tmp_path / "port").restore(
        like=jax.tree.map(jnp.asarray, tree))
    for (path, want), (_, g) in zip(leaves_with_paths(tree),
                                    leaves_with_paths(got)):
        np.testing.assert_array_equal(bits(np.asarray(g)), bits(want),
                                      err_msg=str(path))


def test_async_save_and_gc(tmp_path):
    ck = CheckpointManager(tmp_path, keep=2)
    tree = {"w": torch.arange(6, dtype=torch.float32)}
    for step in range(1, 5):
        ck.save(step, tree, blocking=False)
    ck.wait()
    assert ck.all_steps() == [3, 4] and ck.latest_step() == 4
    assert not [p for p in tmp_path.iterdir() if ".tmp" in p.name]
    got, step = ck.restore(like=tree, device="cpu")
    assert step == 4 and torch.equal(got["w"], tree["w"])
    with pytest.raises(ValueError):
        ck.restore(like={"w": tree["w"], "extra": tree["w"]}, device="cpu")


def test_save_then_update_in_place_restores_saved_values(tmp_path):
    """The host copy is taken before `save` returns: an update in place
    right after a non-blocking save does not reach the files."""
    ck = CheckpointManager(tmp_path)
    w = torch.ones(256, 64)
    b16 = torch.ones(8, dtype=torch.bfloat16)
    ck.save(1, {"b16": b16, "w": w}, blocking=False)
    w.add_(1.0)
    b16.mul_(3)
    ck.wait()
    got, _ = ck.restore(like={"b16": b16, "w": w}, device="cpu")
    assert torch.equal(got["w"], torch.ones(256, 64))
    assert torch.equal(got["b16"], torch.ones(8, dtype=torch.bfloat16))


def test_restore_without_checkpoint_or_like_raises(tmp_path):
    ck = CheckpointManager(tmp_path)
    with pytest.raises(FileNotFoundError):
        ck.restore(like={}, device="cpu")
    ck.save(0, {"w": torch.zeros(2)})
    with pytest.raises(ValueError, match="like"):
        ck.restore(device="cpu")
