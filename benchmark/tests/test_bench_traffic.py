"""The traffic's draws are fixed by the seed, for seeds of any size."""

import numpy as np

from benchmark.harness.traffic import OPPOSITE, image_seeds, key_sequence, sample_pixels

BIG = 2**31 + 12345


def test_image_seeds_repeat_by_seed():
    assert image_seeds(BIG, 50) == image_seeds(BIG, 50)
    assert image_seeds(BIG, 50) != image_seeds(BIG + 1, 50)
    assert all(0 <= s < 2**32 for s in image_seeds(BIG, 50))


def test_keys_repeat_by_seed_and_return_every_step():
    keys = key_sequence(BIG, 40)
    assert keys == key_sequence(BIG, 40) and keys != key_sequence(7, 40)
    assert all(OPPOSITE[a] == b for a, b in zip(keys[::2], keys[1::2]))


def test_pixels_repeat_by_seed():
    a = sample_pixels(BIG, 1920, 1080, 2048, even=False)
    assert np.array_equal(a, sample_pixels(BIG, 1920, 1080, 2048, even=False))
    assert len(set(a.tolist())) == 2048 and a.max() < 1920 * 1080
    e = sample_pixels(BIG, 1920, 1080, 2048, even=True)
    assert np.all(e % 2 == 0) and np.all((e // 1920) % 2 == 0)
