"""The traffic generator: the same seed gives the same inputs; every seed
serves the same set of clip lengths."""

import numpy as np
import torch

from portbench import assets, generator, registry

BIG = 2 ** 31 + 12345


def _subject(seed):
    mix = dict(registry.traffic("subject"), frames=5, img_res=[24, 32])
    return generator.subject(mix, seed, torch.device("cpu"))


def test_subject_repeats_for_a_seed():
    a, b = _subject(BIG), _subject(BIG)
    for k in ("rgb", "mask"):
        assert torch.equal(a[k], b[k])
    for k in ("expression", "flame_pose", "world_mats"):
        assert np.array_equal(a[k], b[k])
    c = _subject(BIG + 1)
    assert not torch.equal(a["rgb"], c["rgb"])
    assert a["rgb"].shape == (5, 24, 32, 3) and a["rgb"].dtype == torch.uint8
    # a head on white: some pixels white, some not
    assert bool((a["rgb"] == 255).all(-1).any()) and bool((a["mask"] > 0).any())


def test_clips_same_lengths_for_every_seed():
    mix = registry.traffic("clips")
    a, b = generator.clips(mix, BIG), generator.clips(mix, 7)
    assert sorted(a["lengths"]) == sorted(b["lengths"])
    assert not np.array_equal(a["expression"], b["expression"])
    # a mix of several lengths is served in an order drawn from the seed
    mixed = dict(mix, clip_frames_min=25, clip_frames_max=200, n_lengths=16)
    c, d = generator.clips(mixed, BIG), generator.clips(mixed, 7)
    assert sorted(c["lengths"]) == sorted(d["lengths"]) and c["lengths"] != d["lengths"]
    assert min(a["lengths"]) >= mix["clip_frames_min"]
    assert max(a["lengths"]) <= mix["clip_frames_max"]
    again = generator.clips(mix, BIG)
    assert np.array_equal(a["expression"], again["expression"])
    assert a["expression"].shape == (sum(a["lengths"]), mix["n_exp"])


def test_assets_repeat_for_a_seed():
    d1, d2 = assets.flame_data(BIG, n_verts=200), assets.flame_data(BIG, n_verts=200)
    for k in d1:
        assert np.array_equal(d1[k], d2[k])
    p1, s1 = assets.fateavatar_avatar(BIG, d1, 40, 32, 10, torch.device("cpu"))
    p2, s2 = assets.fateavatar_avatar(BIG, d1, 40, 32, 10, torch.device("cpu"))
    assert all(torch.equal(p1[k], p2[k]) for k in p1)
    assert all(torch.equal(s1[k], s2[k]) for k in s1)
    assert int(s1["alive"].sum()) == 32
    assert torch.allclose(s1["bary_coords"][:32].sum(-1), torch.ones(32))
