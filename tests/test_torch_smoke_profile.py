"""``chip_smoke.py``'s profiled request, held on the CPU with a fake take.

The profiler's device trace can lose a whole replayed request's kernels (a
take of five MobileNetV1 requests read 0.8 of each kernel's launches on the
H100).  ``_device_breakdown`` then takes the profile again, and only a take
whose launches are short of the path's, and over it for none, is set
aside; ``_check_profiled_launches`` still holds the kept take exactly.
"""

import pytest

import chip_smoke

WANT = {"int8_gemm": 12, "dw_conv": 11, "dw_conv_s1": 7, "dw_conv_s2": 4,
        "dw_pw_fused": 2, "nms": 0}
WHOLE = {"int8_gemm": 12.0, "dw_conv": 11.0, "nms": 0, "dw_pw_fused": 2.0}
LOST = {"int8_gemm": 9.6, "dw_conv": 8.8, "nms": 0, "dw_pw_fused": 1.6}
OVER = {"int8_gemm": 13.0, "dw_conv": 11.0, "nms": 0, "dw_pw_fused": 2.0}


@pytest.mark.parametrize("takes, n_taken, n_lost, passes", [
    ([WHOLE], 1, 0, True),
    ([LOST, WHOLE], 2, 1, True),
    ([LOST] * chip_smoke.PROFILE_TAKES, chip_smoke.PROFILE_TAKES,
     chip_smoke.PROFILE_TAKES, False),
    ([OVER, WHOLE], 1, 0, False),
], ids=["whole", "lost-then-whole", "always-lost", "over"])
def test_a_take_that_lost_launches_is_taken_again(monkeypatch, takes, n_taken,
                                                   n_lost, passes):
    taken = []

    def take(pred, feed, top, reqs):
        taken.append(reqs)
        return {"kernel_launches": dict(takes[len(taken) - 1]), "device_ms": 1.0}

    monkeypatch.setattr(chip_smoke, "_profile_take", take)
    prof = chip_smoke._device_breakdown(None, None, want=WANT)
    assert len(taken) == n_taken
    assert len(prof["lost_takes"]) == n_lost
    if passes:
        chip_smoke._check_profiled_launches("path", prof, WANT)
    else:
        with pytest.raises(SystemExit):
            chip_smoke._check_profiled_launches("path", prof, WANT)
