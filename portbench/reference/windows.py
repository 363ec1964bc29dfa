"""Which frames make each sliding window of the video engine, worked out
from a video's frame keys and sharp labels alone: border reflection, the
nearest pre / sub sharp frames with the published dataset's rules, and the
7-frame limit past which the sub-sharp anchor is a zero frame and the
window has no sharp search. A frozen copy of the published index logic
(inference_SPEINet.py's gene_seq / gene_seq_nsf, videodata_nfs.py's
return_blurry_indices)."""

from __future__ import annotations

import os
from typing import List, Sequence, Tuple

ZERO = "<ZERO>"


def return_blurry_indices(labels: Sequence[int], dist: int = 7
                          ) -> Tuple[List[int], List[int]]:
    """Per frame, the index of the nearest preceding / following sharp
    frame, with the published fallbacks and final fix-up pass."""
    n = len(labels)
    sharp = [i for i in range(n) if labels[i] == 1]
    pre_i, sub_i = 0, 1
    pre: List[int] = []
    sub: List[int] = []
    if len(sharp) > 1:
        for i in range(n):
            if i < sharp[pre_i]:
                if sharp[pre_i] - i < dist:
                    pre.append(sharp[pre_i])
                    sub.append(sharp[pre_i])
                else:
                    pre.append(i - 2 if i > 1 else i)
                    sub.append(i + 2 if i < n - 2 else i)
            elif i == sharp[pre_i]:
                pre.append(i)
                sub.append(i)
            elif sharp[pre_i] < i < sharp[sub_i]:
                pre.append(sharp[pre_i] if i - sharp[pre_i] < dist else i - 2)
                sub.append(sharp[sub_i] if sharp[sub_i] - i < dist else i + 2)
            elif i == sharp[sub_i]:
                pre_i += 1
                sub_i += 1
                if sub_i > len(sharp) - 1:
                    sub_i -= 1
                    pre_i -= 1
                pre.append(i)
                sub.append(i)
            else:
                if i - sharp[sub_i] < dist:
                    pre.append(sharp[sub_i])
                    sub.append(sharp[sub_i])
                else:
                    pre.append(i - 2)
                    sub.append(i + 2 if i < n - 2 else i)
    else:
        for i in range(n):
            if i == 0:
                pre.append(i)
                sub.append(i + 1)
            elif i == n - 1:
                pre.append(i - 1)
                sub.append(i)
            else:
                pre.append(i - 1)
                sub.append(i + 1)
    for lst in (pre, sub):
        m = len(lst)
        for i in range(m):
            if lst[i] not in sharp:
                lst[i] = m - 1 if i < m // 2 else 0
    return pre, sub


def _reflect(items: list, n_seq: int) -> list:
    half = n_seq // 2
    head = items[1:1 + half][::-1]
    tail = items[-half - 1:-1][::-1]
    return head + list(items) + tail


def _number(key: str) -> int:
    return int(os.path.splitext(os.path.basename(key))[0].split(".")[-1])


def windows(keys: Sequence[str], labels: Sequence[int], n_seq: int) -> List[tuple]:
    """Per window, in order: (frame keys of the window, has_sharp, anchor
    key or ZERO). Both sharp frames are measured from the window's last
    frame; the pre-sharp one decides the routing, the sub-sharp one is
    the anchor."""
    padded = _reflect(list(keys), n_seq)
    lab = _reflect([int(v) for v in labels], n_seq)
    pre, sub = return_blurry_indices(lab)
    out = []
    for w in range(len(padded) - 2 * (n_seq // 2)):
        frames = tuple(padded[w:w + n_seq])
        ref_n = _number(frames[-1])
        has_sharp = abs(ref_n - _number(padded[pre[w]])) <= 7
        anchor = padded[sub[w + n_seq - 1]]
        out.append((frames, has_sharp, anchor if abs(ref_n - _number(anchor)) <= 7
                    else ZERO))
    return out
