"""Sharp-frame index computation and sliding-window generation.

The port's own copy of `speinet_tpu/data/indices.py`; keep the two in step.

Pure-Python parity ports of the reference's index logic, which defines the
dataset semantics (these are specifications, not hot paths):
- `return_blurry_indices`: data/videodata_nfs.py:51-125 (identical copy
  also lives at inference_SPEINet.py:239-313) — for each frame, the index
  of the nearest preceding/following *sharp* frame, with the dist<7 rule,
  the +-2 fallback for far sharp frames, and the final fix-up pass that
  redirects non-sharp fallbacks to the sequence ends.
- `gene_seq` / `gene_seq_nsf`: inference_SPEINet.py:431-464 — border
  reflection and sliding 3-windows.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple


def return_blurry_indices(detect_result: Sequence[int], dist: int = 7
                          ) -> Tuple[List[int], List[int]]:
    """Per-frame nearest pre/sub sharp-frame indices from 0/1 labels.

    Exact behavioral parity with videodata_nfs.py:51-125, including its
    quirks (the fix-up loops that rewrite fallback indices to
    len-1 / 0 when they do not land on a sharp frame).
    """
    n = len(detect_result)
    sharp = [i for i in range(n) if detect_result[i] == 1]
    pre_i, sub_i = 0, 1
    pre_list: List[int] = []
    sub_list: List[int] = []
    if len(sharp) > 1:
        for i in range(n):
            if i < sharp[pre_i]:
                if sharp[pre_i] - i < dist:
                    pre_list.append(sharp[pre_i])
                    sub_list.append(sharp[pre_i])
                else:
                    pre_list.append(i - 2 if i > 1 else i)
                    sub_list.append(i + 2 if i < n - 2 else i)
            elif i == sharp[pre_i]:
                pre_list.append(i)
                sub_list.append(i)
            elif sharp[pre_i] < i < sharp[sub_i]:
                if i - sharp[pre_i] < dist:
                    pre_list.append(sharp[pre_i])
                else:
                    pre_list.append(i - 2)
                if sharp[sub_i] - i < dist:
                    sub_list.append(sharp[sub_i])
                else:
                    sub_list.append(i + 2)
            elif i == sharp[sub_i]:
                pre_i += 1
                sub_i += 1
                if sub_i > len(sharp) - 1:
                    sub_i -= 1
                    pre_i -= 1
                pre_list.append(i)
                sub_list.append(i)
            elif i > sharp[sub_i]:
                if i - sharp[sub_i] < dist:
                    pre_list.append(sharp[sub_i])
                    sub_list.append(sharp[sub_i])
                else:
                    pre_list.append(i - 2)
                    sub_list.append(i + 2 if i < n - 2 else i)
    else:
        for i in range(n):
            if i == 0:
                pre_list.append(i)
                sub_list.append(i + 1)
            elif i == n - 1:
                pre_list.append(i - 1)
                sub_list.append(i)
            else:
                pre_list.append(i - 1)
                sub_list.append(i + 1)

    # fix-up pass (videodata_nfs.py:106-123)
    pl, sl = len(pre_list), len(sub_list)
    for i in range(pl // 2):
        if pre_list[i] not in sharp:
            pre_list[i] = pl - 1
    for i in range(pl // 2, pl):
        if pre_list[i] not in sharp:
            pre_list[i] = 0
    for i in range(sl // 2):
        if sub_list[i] not in sharp:
            sub_list[i] = sl - 1
    for i in range(sl // 2, sl):
        if sub_list[i] not in sharp:
            sub_list[i] = 0
    return pre_list, sub_list


def gene_seq(img_list: list, n_seq: int, border: bool = True):
    """Border-reflected sliding windows (inference_SPEINet.py:431-444).

    Returns (list of n_seq-windows, the (possibly padded) frame list)."""
    img_list = list(img_list)
    if border:
        half = n_seq // 2
        tmp = img_list[1 : 1 + half]
        tmp.reverse()
        tmp.extend(img_list)
        end = img_list[-half - 1 : -1]
        end.reverse()
        tmp.extend(end)
        img_list = tmp
    seqs = [img_list[i : i + n_seq] for i in range(len(img_list) - 2 * (n_seq // 2))]
    return seqs, img_list


def gene_seq_nsf(labels, n_seq: int, border: bool = True):
    """Per-window pre/sub sharp index windows (inference_SPEINet.py:446-464)."""
    lab = [int(v) for v in list(labels)]
    if border:
        half = n_seq // 2
        tmp = lab[1 : 1 + half]
        tmp.reverse()
        tmp.extend(lab)
        end = lab[-half - 1 : -1]
        end.reverse()
        tmp.extend(end)
        lab = tmp
    pre_list, sub_list = return_blurry_indices(lab)
    pre = [pre_list[i : i + n_seq] for i in range(len(lab) - 2 * (n_seq // 2))]
    sub = [sub_list[i : i + n_seq] for i in range(len(lab) - 2 * (n_seq // 2))]
    return pre, sub


def frame_number(filename: str) -> int:
    """'video.000017' -> 17 (inference_SPEINet.py:371-372)."""
    return int(filename.split(".")[-1])
