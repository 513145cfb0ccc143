"""The port's data modules against the JAX package's, exactly: the dataset
scan and decode, the Loader's batches (order, crops, wrap, sharding, cache)
byte for byte, and the on-device augmentation at fixed angles and flips."""

import numpy as np
import pytest

pytest.importorskip("jax")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from curl_tpu import data as jdata  # noqa: E402
from curl_tpu_torch import data as tdata  # noqa: E402
from curl_tpu_torch.data import augment as taug  # noqa: E402

NAMES = ["1", "2", "3", "a0004", "a0005", "a0006"]


def write_mini_dataset(root, with_test_split=False):
    """A 6-image paired dataset with masks and split files, as PNGs of
    varied sizes with integer and Adobe-style ids (as tests/test_data.py
    builds it)."""
    from PIL import Image

    for d in ("train_input", "train_output", "train_mask"):
        (root / d).mkdir()
    rng = np.random.default_rng(0)
    for i, name in enumerate(NAMES):
        h, w = 40 + 8 * i, 56 + 4 * i
        arr = rng.uniform(0, 255, (h, w, 3)).astype(np.uint8)
        out = np.clip(arr.astype(np.int32) + 20, 0, 255).astype(np.uint8)
        mask = (rng.uniform(size=(h, w)) < 0.9).astype(np.uint8) * 255
        Image.fromarray(arr).save(root / "train_input" / f"{name}.png")
        Image.fromarray(out).save(root / "train_output" / f"{name}.png")
        Image.fromarray(mask).save(root / "train_mask" / f"{name}.png")
    (root / "images_train.txt").write_text("\n".join(NAMES[:4]) + "\n")
    (root / "images_valid.txt").write_text("\n".join(NAMES[4:]) + "\n")
    if with_test_split:
        (root / "images_inference.txt").write_text("\n".join(NAMES[3:]) + "\n")
    return root


@pytest.fixture(scope="module")
def mini_dataset(tmp_path_factory):
    return write_mini_dataset(tmp_path_factory.mktemp("torch_adobe_mini"))


def _records(mod, root, split="train"):
    return mod.select_records(mod.scan_data_dir(root),
                              mod.read_split_ids(root / f"images_{split}.txt"))


def test_scan_split_and_load_match_jax(mini_dataset):
    t, j = tdata.scan_data_dir(mini_dataset), jdata.scan_data_dir(mini_dataset)
    assert {k: tuple(vars(r).values()) for k, r in t.items()} == {
        k: tuple(vars(r).values()) for k, r in j.items()}
    assert [r.key for r in _records(tdata, mini_dataset)] == NAMES[:4]
    with pytest.raises(KeyError, match="zzz"):
        tdata.select_records(t, ["zzz"])
    ex_t, ex_j = tdata.load_example(t["a0004"]), jdata.load_example(j["a0004"])
    for k in ("input_img", "output_img", "mask"):
        assert ex_t[k].dtype == np.uint8
        np.testing.assert_array_equal(ex_t[k], ex_j[k])
    assert ex_t["name"] == ex_j["name"] == "a0004.png"
    for crop in ((32, 32), (64, 80)):  # center, and pad-if-needed
        a = tdata.crop_pair(ex_t, *crop, np.random.default_rng(3))
        b = jdata.crop_pair(ex_j, *crop, np.random.default_rng(3))
        for k in ("input_img", "output_img", "mask"):
            np.testing.assert_array_equal(a[k], b[k])
            np.testing.assert_array_equal(tdata.crop_pair(ex_t, *crop)[k],
                                          jdata.crop_pair(ex_j, *crop)[k])


def test_mask_optional(tmp_path):
    from PIL import Image

    (tmp_path / "x_input").mkdir()
    (tmp_path / "x_output").mkdir()
    img = Image.fromarray(np.zeros((8, 8, 3), np.uint8))
    img.save(tmp_path / "x_input" / "1.png")
    img.save(tmp_path / "x_output" / "1.png")
    ex = tdata.load_example(tdata.scan_data_dir(tmp_path)["1"])
    assert ex["mask"].shape == (8, 8, 1) and (ex["mask"] == 1).all()


def _assert_batches_equal(t_batches, j_batches):
    assert len(t_batches) == len(j_batches) > 0
    for tb, jb in zip(t_batches, j_batches):
        assert sorted(tb) == sorted(jb)
        for k in ("input_img", "output_img", "mask", "valid_count"):
            assert tb[k].dtype == jb[k].dtype, k
            np.testing.assert_array_equal(tb[k], jb[k], err_msg=k)
        assert tb["name"] == jb["name"]


@pytest.mark.parametrize("kwargs", [
    dict(split="train", batch_size=2, crop=(32, 32), train=True, seed=1),
    dict(split="train", batch_size=2, crop=(64, 72), train=True, seed=5, cache_mb=1),
    dict(split="train", batch_size=4, crop=(32, 32), train=True, seed=2,
         process_index=1, process_count=2),
    dict(split="valid", batch_size=4, crop=(32, 40), train=False),
    dict(split="train", batch_size=3, crop=None, train=False, num_threads=1),
], ids=["train", "pad-crop-cache", "shard", "eval-wrap", "no-crop"])
def test_loader_batches_match_jax_byte_for_byte(mini_dataset, kwargs):
    kwargs = dict(kwargs)
    split = kwargs.pop("split")
    if kwargs["crop"] is None:  # uncropped images differ in size: one per batch
        kwargs["batch_size"] = 1
    t = tdata.Loader(_records(tdata, mini_dataset, split), **kwargs)
    j = jdata.Loader(_records(jdata, mini_dataset, split), **kwargs)
    assert len(t) == len(j)
    for epoch in (0, 1):
        t.set_epoch(epoch)
        j.set_epoch(epoch)
        _assert_batches_equal(list(t), list(j))
    if kwargs.get("cache_mb"):
        assert t.cache_stats()["hits"] > 0
        assert t.cache_stats() == j.cache_stats()


def test_to_device_and_prefetch(mini_dataset):
    loader = tdata.Loader(_records(tdata, mini_dataset), batch_size=2, crop=(32, 32),
                          train=True)
    batches = [tdata.to_device(b, "cpu") for b in tdata.prefetch(iter(loader))]
    assert len(batches) == 2
    for b, ref in zip(batches, loader):
        assert isinstance(b["input_img"], torch.Tensor) and b["input_img"].dtype == torch.uint8
        np.testing.assert_array_equal(b["mask"].numpy(), ref["mask"])
        assert b["name"] == ref["name"] and int(b["valid_count"]) == 2

    def broken():
        yield 1
        raise OSError("decode failed")

    it = tdata.prefetch(broken())
    assert next(it) == 1
    with pytest.raises(OSError, match="decode failed"):
        next(it)


@pytest.mark.parametrize("shape", [(16, 16, 7), (17, 17, 1), (33, 47, 7), (40, 28, 3)])
@pytest.mark.parametrize("angle", [0.0, np.pi / 2, -np.pi / 2, np.pi, 0.7, -2.9])
def test_rotate_nearest_matches_jax(rng, shape, angle):
    stack = rng.integers(0, 256, shape, dtype=np.uint8)
    expect = np.asarray(jdata.rotate_nearest(jnp.asarray(stack), jnp.float32(angle)))
    got = taug.rotate_nearest(torch.from_numpy(stack), torch.tensor(angle, dtype=torch.float32))
    np.testing.assert_array_equal(got.numpy(), expect)


def test_rotation_identities(rng):
    img = torch.from_numpy(rng.uniform(0, 1, (17, 17, 1)).astype(np.float32))
    np.testing.assert_array_equal(taug.rotate_nearest(img, torch.tensor(0.0)).numpy(), img.numpy())
    np.testing.assert_array_equal(taug.rotate_nearest(img, torch.tensor(np.pi)).numpy(),
                                  img.numpy()[::-1, ::-1])
    ones = torch.ones(32, 32, 1)
    out = taug.rotate_nearest(ones, torch.tensor(np.pi / 4))
    assert out[0, 0, 0] == 0.0 and out[-1, -1, 0] == 0.0 and out[16, 16, 0] == 1.0


def test_augment_batch_is_the_jax_transform_of_its_draws(rng):
    """Each sample's flips and rotation, replayed from the same draws
    through the JAX package's flips and `rotate_nearest`, give the same
    bytes; the mask is re-binarized and the pair moves together."""
    b, s = 6, 24
    inp = rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)
    out = rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)
    mask = (rng.uniform(size=(b, s, s, 1)) < 0.9).astype(np.uint8)
    g = torch.Generator().manual_seed(11)
    draws = torch.rand(3, b, generator=torch.Generator().manual_seed(11))
    a_in, a_out, a_mask = taug.augment_batch(*[torch.from_numpy(x) for x in (inp, out, mask)], g)
    assert a_in.dtype == a_mask.dtype == torch.uint8
    assert set(np.unique(a_mask.numpy())) <= {0, 1}
    stack = np.concatenate([inp, out, mask], axis=-1)
    for i in range(b):
        x = jnp.asarray(stack[i])
        if draws[0, i] < 0.5:
            x = x[:, ::-1]
        if draws[1, i] < 0.5:
            x = x[::-1]
        angle = (2.0 * draws[2, i] - 1.0) * np.pi
        x = np.asarray(jdata.rotate_nearest(x, jnp.float32(angle)))
        np.testing.assert_array_equal(a_in[i].numpy(), x[..., :3])
        np.testing.assert_array_equal(a_out[i].numpy(), x[..., 3:6])
        np.testing.assert_array_equal(a_mask[i].numpy(), (x[..., 6:7] > 0).astype(np.uint8))


def test_augment_u8_matches_float_and_seeds_differ(rng):
    b, s = 2, 24
    inp8 = rng.integers(0, 256, (b, s, s, 3), dtype=np.uint8)
    mask8 = (rng.uniform(size=(b, s, s, 1)) < 0.9).astype(np.uint8)
    t8 = torch.from_numpy(inp8)
    a8, _, m8 = taug.augment_batch(t8, t8, torch.from_numpy(mask8),
                                   torch.Generator().manual_seed(7))
    af, _, mf = taug.augment_batch(t8.float() / 255.0, t8.float() / 255.0,
                                   torch.from_numpy(mask8).float(),
                                   torch.Generator().manual_seed(7))
    np.testing.assert_array_equal(a8.float().numpy() / 255.0, af.numpy())
    np.testing.assert_array_equal(m8.float().numpy(), mf.numpy())
    other, _, _ = taug.augment_batch(t8, t8, torch.from_numpy(mask8),
                                     torch.Generator().manual_seed(8))
    assert not torch.equal(other, a8)
