#!/usr/bin/env python3
"""K11 at D = 1024, batch 128, traced entry by entry to int8 codes, on one GPU.

    python3 k11_codes.py

Builds the CUDA kernels as ``chip_smoke.py`` does, then runs the int8
attention sublayer (``ops/block_int8.py:fused_attn_sublayer_int8``) at the
latent ImageNet-256 width (L = 258, D = 1024, 16 heads) and batch 128, with
and without a qkv bias, against its plain version stage by stage
(``diagnose_k11_codes``). Each entry where the kernel is further from plain
than plain with its keys and values in another order gets its row explained,
if it can be, by int8 codes that moved a step. It prints what it found and
one JSON line ``{"k11_codes": ...}``; it gates nothing (the gates of K11 are
``chip_smoke.py`` phase 2's).
"""

from __future__ import annotations

import json
import sys

import torch

from chip_smoke import IMAGENET256, MAIN_BATCH, block_modules, setup, to_device


# K11's open check at D = 1024, batch 128: the entries where the kernel
# differs from plain by more than plain with its keys taken in another order
# does, each traced to the int8 codes of its row's merged heads
K11_DIAG_ROWS = 12   # rows printed one by one
K11_MAX_FLIPS = 6    # codes moved a row, at most
K11_LN_TRIES = 16    # LayerNorm + quant codes tried a row, nearest their boundary first


def k11_stages(x, ops, heads: int, core, ln_flip=None) -> dict:
    """Plain K11 (``attn_sublayer_int8_plain``, dynamic scales) stage by
    stage, with the merged heads from ``core(qkv)``; ``ln_flip = (row,
    column, step)`` moves one code of the LayerNorm + quant stage. Returns
    the output, the LayerNorm output in code units, the merged heads (fp32
    of their bf16 values), their int8 codes and row scales."""
    from duodiff_tpu_torch.ops.block import _layer_norm
    from duodiff_tpu_torch.ops.block_int8 import _int8_matmul, _quant_rows

    ln_scale, ln_bias, wqkv8, sqkv, bqkv, wp8, sp, bp = ops
    xv = x.float()
    xn = _layer_norm(xv, ln_scale.float(), ln_bias.float(), 1e-5)
    x8, rs = _quant_rows(xn)
    if ln_flip is not None:
        row, col, step = ln_flip
        x8[:, row, col] += step
    qkv = _int8_matmul(x8, wqkv8) * (rs * sqkv)
    if bqkv is not None:
        qkv = qkv + bqkv
    merged = core(qkv.to(x.dtype)).float()
    m8, mrs = _quant_rows(merged)
    out = (xv + _int8_matmul(m8, wp8) * (mrs * sp) + bp).to(x.dtype)
    return {"out": out, "ln_codes": xn / rs, "merged": merged, "m8": m8, "mrs": mrs}


def bf16_ulp(t: torch.Tensor) -> torch.Tensor:
    """One bf16 ulp of each value (of its magnitude's binade)."""
    return 2.0 ** (torch.floor(torch.log2(t.abs().clamp_min(2.0**-126))) - 7)


def fit_code_flips(kernel_row, out, basis) -> tuple:
    """Greedy: the merged-head codes, each moved by one step, that make the
    most entries of ``bf16(out + their steps)`` equal the kernel's row, one
    code at a time, at most K11_MAX_FLIPS; ``basis[j]`` is code j's step in
    the output (K, N). Returns ([(code, +1 or -1)], the fitted fp32 row)."""
    flips = []
    for _ in range(K11_MAX_FLIPS):
        now = int((out.to(torch.bfloat16).float() == kernel_row).sum())
        best = None
        for sign in (1, -1):
            trial = (out + sign * basis).to(torch.bfloat16).float()
            hits = (trial == kernel_row).sum(1)
            j = int(hits.argmax())
            if int(hits[j]) > now and (best is None or int(hits[j]) > best[2]):
                best = (j, sign, int(hits[j]))
        if best is None:
            break
        out = out + best[1] * basis[best[0]]
        flips.append(best[:2])
    return flips, out


def explain_k11_row(kernel_row, x_row, merged_row, ops) -> dict:
    """The kernel's output row as plain's proj on int8 codes of plain's merged
    heads, with the row's amax (a bf16 value) as it is or one bf16 ulp up or
    down, and a few codes moved by a step beyond that
    (:func:`fit_code_flips`). Returns the best fit: the amax's move in ulps,
    the moved codes with how far plain's value sat from the rounding
    boundary (in codes) and the code width of one bf16 ulp of it, and the
    fitted row rounded to bf16."""
    _, _, _, _, _, wp8, sp, bp = ops
    amax = merged_row.abs().max()
    best = None
    for move in (0, 1, -1):
        top = amax + move * bf16_ulp(amax)
        inv = top.new_tensor(127.0) / top
        m8 = torch.clamp(torch.round(merged_row * inv), -127, 127)
        scale = top / 127.0
        out = x_row + (m8.double() @ wp8.double().t()).float() * (scale * sp) + bp
        flips, out = fit_code_flips(kernel_row, out, wp8.float().t() * (scale * sp))
        row = out.to(torch.bfloat16).float()
        misses = int((row != kernel_row).sum())
        if best is None or misses < best["misses"]:
            pos = merged_row * inv
            near = [(abs(float(pos[j] - torch.floor(pos[j]) - 0.5)),
                     float(bf16_ulp(merged_row[j]) * inv)) for j, _ in flips]
            best = {"amax_move": move, "flips": flips, "near": near, "row": row,
                    "misses": misses}
    return best


def explain_k11_ln(kernel_row, x_one, l: int, ln_codes, ops, heads: int, core) -> dict:
    """The kernel's output row ``l`` of one batch element as plain with one
    code of the element's LayerNorm + quant stage moved by a step (towards
    the other side of its rounding boundary; a token's codes feed its own
    query and every row's keys and values), for each of the K11_LN_TRIES
    codes of the element nearest their boundary, then the merged heads
    fitted as in :func:`explain_k11_row`. Returns the best: its (token,
    column), distance from the boundary in codes, the fitted row and how
    many entries of it differ from the kernel's, and every code tried."""
    frac = ln_codes - torch.floor(ln_codes)
    dist = (frac - 0.5).abs()
    best, tried = None, []
    for flat in torch.argsort(dist.flatten())[:K11_LN_TRIES].tolist():
        t, col = divmod(flat, ln_codes.shape[1])
        step = 1 if frac[t, col] < 0.5 else -1
        moved = k11_stages(x_one, ops, heads, core, ln_flip=(t, col, step))
        fit = explain_k11_row(kernel_row, x_one[0, l].float(), moved["merged"][0, l], ops)
        tried.append(((t, col), float(dist[t, col]), fit["misses"]))
        if best is None or fit["misses"] < best["misses"]:
            best = {"code": (t, col), "dist": float(dist[t, col]), "row": fit["row"],
                    "misses": fit["misses"]}
    return {**best, "tried": tried}


def diagnose_k11_codes(device) -> dict:
    """K11 at D = 1024, batch 128, with and without a qkv bias, against
    plain and against plain with its keys and values in a fixed random
    order (the same function, other fp32 sums: ``reordered``). Each row with
    an entry where the kernel is further from plain than the reordered plain
    ever is gets the kernel's row explained by int8 codes of plain's merged
    heads (:func:`explain_k11_row`): the row's scale moved by an ulp of its
    amax, and a few codes moved by one step; a row that this does not explain
    is tried with one code of its LayerNorm + quant stage moved instead
    (:func:`explain_k11_ln`). A row is a code flip where the fitted row
    equals the kernel's to the bit at those entries (and every moved
    merged-head code lay within one bf16 ulp of its rounding boundary).
    Prints the verdict; fails nothing: the gates stay check_int8_kernels'."""
    from duodiff_tpu_torch.ops import block_int8 as q
    from duodiff_tpu_torch.ops.block import attention_core_plain

    w, verdicts = IMAGENET256, {}
    a = w.d
    perm = torch.randperm(w.l, generator=torch.Generator().manual_seed(11)).to(device)

    def plain_core(qkv):
        return attention_core_plain(qkv, w.heads, qkv.dtype)

    def reordered_core(qkv):
        return plain_core(torch.cat([qkv[..., :a], qkv[..., a:][:, perm]], -1))

    for qkv_bias in (False, True):
        x, norm, qkv, proj, _, _ = block_modules(MAIN_BATCH, qkv_bias, width=w)
        x = x.to(device)
        ops = to_device(q.pack_attn_int8(norm, qkv, proj, num_heads=w.heads), device)
        kernel = q.fused_attn_sublayer_int8(x, *ops, num_heads=w.heads).float()
        plain = k11_stages(x, ops, w.heads, plain_core)
        same = torch.equal(plain["out"], q.attn_sublayer_int8_plain(x, *ops, num_heads=w.heads))
        want = plain["out"].float()
        worst = (k11_stages(x, ops, w.heads, reordered_core)["out"].float() - want).abs().max()
        err = (kernel - want).abs()
        bad = torch.nonzero(err > worst)
        rows = torch.unique(bad[:, :2], dim=0).tolist()
        label = f"K11 D={w.d} L={w.l} B={MAIN_BATCH} qkv_bias={qkv_bias}"
        print(f"phase 2: {label} codes: kernel vs plain max {err.max().item():.6g} "
              f"({int((err > 0.03).sum())} entries > 0.03); reordered plain vs plain max "
              f"{worst.item():.6g}; stage-by-stage plain equals attn_sublayer_int8_plain: "
              f"{same}; {len(bad)} entries in {len(rows)} rows past the reordered plain's worst",
              flush=True)
        explained = 0
        for i, (b, l) in enumerate(rows):
            cols = bad[(bad[:, 0] == b) & (bad[:, 1] == l), 2]
            fit = explain_k11_row(kernel[b, l], x[b, l].float(), plain["merged"][b, l], ops)
            at_them = (fit["row"][cols] - kernel[b, l, cols]).abs().max().item()
            ok = at_them == 0.0 and all(d <= u for d, u in fit["near"])
            if not ok:  # one code of the row's LayerNorm + quant moved instead
                ln = explain_k11_ln(kernel[b, l], x[b:b + 1], l, plain["ln_codes"][b], ops,
                                    w.heads, plain_core)
                ln_at_them = (ln["row"][cols] - kernel[b, l, cols]).abs().max().item()
                ok = ln_at_them == 0.0
                tried = [(c, f"{d:.3g}", m) for c, d, m in ln["tried"]]
                print(f"phase 2: {label} codes: row ({b}, {l}): the LayerNorm + quant codes of "
                      f"batch element {b} nearest their rounding boundary, (token, column), "
                      f"distance in codes, entries of the row then unlike the kernel's: {tried}; "
                      f"the best, {ln['code']} ({ln['dist']:.3g} codes from its boundary), "
                      f"leaves {ln_at_them:.6g} at those entries and {ln['misses']} of {w.d} "
                      f"entries of the row different; a code flip in the LayerNorm + quant: "
                      f"{ok}", flush=True)
            explained += ok
            if i < K11_DIAG_ROWS:
                near = [f"{d:.3g} codes from its boundary (1 ulp = {u:.3g})"
                        for d, u in fit["near"]]
                print(f"phase 2: {label} codes: row ({b}, {l}): {len(cols)} entries, max |kernel "
                      f"- plain| {err[b, l, cols].max().item():.6g}; the row's amax moved "
                      f"{fit['amax_move']} ulp, codes changed {fit['flips']}: {near}; the fitted "
                      f"row vs the kernel's: {at_them:.6g} at those entries, "
                      f"{fit['misses']} of {w.d} entries of the row differ; a code flip: {ok}",
                      flush=True)
        verdicts[f"qkv_bias={qkv_bias}"] = {
            "kernel_vs_plain_max": err.max().item(), "reordered_vs_plain_max": worst.item(),
            "entries_past": len(bad), "rows_past": len(rows),
            "rows_explained_by_code_flips": explained,
        }
        del kernel, plain, want, err
    print(json.dumps({"k11_codes": verdicts}), flush=True)
    return verdicts


# the batch element of the one entry past the reordered plain's worst with a
# qkv bias (row (101, 24), 0.0662 from plain on an H100)
K11_TRACE_ELEMENT = 101
K11_TRACE_ROW = 24


def bf16_flip_only(got: torch.Tensor, exact: torch.Tensor) -> torch.Tensor:
    """Where ``got`` (bf16 values as fp32) is one of the two bf16 values
    around the fp32 ``exact``: a rounding of ``exact`` to either side, what
    an fp32 difference of an ulp or so in ``exact`` can move."""
    return (got - exact).abs() < bf16_ulp(exact)


def stage_diff(label: str, got: torch.Tensor, want: torch.Tensor, exact=None) -> dict:
    """Entries of ``got`` unlike ``want`` (both bf16 values or codes as fp32)
    and the largest difference; with ``exact``, the fp32 values ``want``
    rounds, also how many of the differing entries are a bf16 rounding of
    ``exact`` to its other side (:func:`bf16_flip_only`)."""
    diff = got != want
    n = int(diff.sum())
    out = {"entries": got.numel(), "differ": n,
           "max_abs": (got - want).abs().max().item() if n else 0.0}
    if exact is not None and n:
        out["differ_beyond_a_rounding_flip"] = int((diff & ~bf16_flip_only(got, exact)).sum())
    print(f"k11 stages: {label}: {out}", flush=True)
    return out


def k11_launch_keeping(x, ops, heads: int, eps: float = 1e-5):
    """K11 with dynamic scales, launched as ``fused_attn_sublayer_int8``'s
    CUDA wrapper launches it, keeping the buffers its launches pass between
    stages. Returns (y, kept): ``qkv`` (B*L, 3A) bf16 after the dequant, the
    bias and the rounding; ``merged`` (B*L, A) bf16, the attention core's
    heads; ``m8`` (B*L, A) int8 and ``mrs`` (B*L,) fp32, their codes and row
    scales, as the proj GEMM read them."""
    from duodiff_tpu_torch.ops._build import load_library
    from duodiff_tpu_torch.ops.block import _ptr, _raise_on_error

    ln_scale, ln_bias, wqkv8, sqkv, bqkv, wp8, sp, bp = ops
    b, l, d = x.shape
    m, dev = b * l, x.device
    x8 = torch.empty((m, d), dtype=torch.int8, device=dev)  # reused for the merged heads
    rs = torch.empty((m,), dtype=torch.float32, device=dev)
    qkv = torch.empty((m, 3 * d), dtype=torch.bfloat16, device=dev)
    merged = torch.empty((m, d), dtype=torch.bfloat16, device=dev)
    y = torch.empty_like(x)
    lib = load_library()
    err = lib.duodiff_attn_sublayer_int8(
        _ptr(x), _ptr(ln_scale), _ptr(ln_bias), _ptr(wqkv8), _ptr(sqkv), _ptr(bqkv),
        _ptr(wp8), _ptr(sp), _ptr(bp), None, _ptr(x8), _ptr(rs), _ptr(qkv), _ptr(merged),
        _ptr(y), b, l, d, heads, eps, torch.cuda.current_stream(dev).cuda_stream,
    )
    _raise_on_error(lib, "int8 attention sublayer kernel", err)
    return y, {"qkv": qkv, "merged": merged, "m8": x8, "mrs": rs}


def trace_k11_stages(device) -> dict:
    """K11 at D = 1024, batch 128, with and without a qkv bias: the kernel's
    intermediates against plain's, for the whole batch and for batch element
    K11_TRACE_ELEMENT alone (q, k and v apart). Plain's stages follow
    ``attn_sublayer_int8_plain``: qkv = acc_f32 * (rs * sqkv), + the fp32
    bias, one cast to bf16 (duodiff_tpu/ops/pallas_block_int8.py:124-129);
    the bf16 core; per-row codes of the merged heads; the proj with the fp32
    residual and bias. Each later stage is also taken from the kernel's own
    input to it, so a difference is pinned to the stage that makes it."""
    from duodiff_tpu_torch.ops import block_int8 as q
    from duodiff_tpu_torch.ops.block import _layer_norm, attention_core_plain
    from duodiff_tpu_torch.ops.gemm import ln_quant_rows

    w, out = IMAGENET256, {}
    a, b = w.d, K11_TRACE_ELEMENT
    for qkv_bias in (True, False):
        x, norm, qkv_mod, proj, _, _ = block_modules(MAIN_BATCH, qkv_bias, width=w)
        x = x.to(device)
        ops = to_device(q.pack_attn_int8(norm, qkv_mod, proj, num_heads=w.heads), device)
        ln_scale, ln_bias, wqkv8, sqkv, bqkv, wp8, sp, bp = ops
        kernel, keep = k11_launch_keeping(x, ops, w.heads)
        torch.cuda.synchronize()
        shape = (MAIN_BATCH, w.l)
        k_qkv = keep["qkv"].reshape(*shape, 3 * a).float()
        k_merged = keep["merged"].reshape(*shape, a).float()
        k_m8 = keep["m8"].reshape(*shape, a).float()
        k_mrs = keep["mrs"].reshape(*shape, 1)
        # plain, stage by stage
        xv = x.float()
        xn = _layer_norm(xv, ln_scale, ln_bias, 1e-5)
        x8, rs = q._quant_rows(xn)
        exact = q._int8_matmul(x8, wqkv8) * (rs * sqkv)
        if bqkv is not None:
            exact = exact + bqkv
        p_qkv = exact.to(torch.bfloat16)
        label = f"D={w.d} B={MAIN_BATCH} qkv_bias={qkv_bias}"
        res = {"qkv": stage_diff(f"{label} qkv", k_qkv, p_qkv.float(), exact)}
        # the LayerNorm + quant pass that fed the kernel's qkv GEMM, alone
        k_x8, k_rs = ln_quant_rows(x.reshape(-1, a), ln_scale, ln_bias)
        k_x8, k_rs = k_x8.reshape(*shape, a), k_rs.reshape(*shape, 1)
        flips = (k_x8.float() - x8.float()).abs()
        # where a code moved in a row whose scale did not: how far plain's
        # value sat from the rounding boundary, in codes
        pos = xn * (xn.new_tensor(127.0) / xn.abs().amax(-1, keepdim=True))
        same_scale = (flips > 0) & (k_rs == rs)
        dist = ((pos - torch.floor(pos)) - 0.5).abs()[same_scale]
        res["ln_codes"] = {"entries": flips.numel(), "differ": int((flips > 0).sum()),
                           "boundary_distance_max": dist.max().item() if dist.numel() else None,
                           "max_abs": flips.max().item(),
                           "rows_with_a_flip": int((flips.amax(-1) > 0).sum()),
                           "row_scales_differ": int((k_rs != rs).sum()),
                           f"differ[{b}]": int((flips[b] > 0).sum()),
                           f"row_scales_differ[{b}]": int((k_rs[b] != rs[b]).sum())}
        print(f"k11 stages: {label} LayerNorm + quant codes vs plain's: {res['ln_codes']}",
              flush=True)
        from_ln = q._int8_matmul(k_x8, wqkv8) * (k_rs * sqkv)
        if bqkv is not None:
            from_ln = from_ln + bqkv
        from_ln = from_ln.to(torch.bfloat16)
        res["qkv_from_kernel_ln_codes"] = stage_diff(
            f"{label} qkv vs plain's epilogue on the kernel's LayerNorm + quant codes", k_qkv,
            from_ln.float())
        for i, part in enumerate("qkv"):
            cols = slice(i * a, (i + 1) * a)
            res[f"{part}[{b}]"] = stage_diff(f"{label} {part} of element {b}",
                                             k_qkv[b, :, cols], p_qkv[b, :, cols].float(),
                                             exact[b, :, cols])
        # the core on the kernel's own q, k, v, then on plain's
        own = attention_core_plain(keep["qkv"].reshape(*shape, 3 * a), w.heads, torch.bfloat16)
        res["merged_from_kernel_qkv"] = stage_diff(f"{label} merged heads vs plain core on the "
                                                   "kernel's q, k, v", k_merged, own.float())
        res[f"merged_from_kernel_qkv[{b}]"] = stage_diff(
            f"{label} merged heads of element {b} vs plain core on the kernel's q, k, v",
            k_merged[b], own[b].float())
        p_merged = attention_core_plain(p_qkv, w.heads, torch.bfloat16).float()
        res["merged"] = stage_diff(f"{label} merged heads vs plain's", k_merged, p_merged)
        # the codes of the kernel's own merged heads
        m8, mrs = q._quant_rows(k_merged)
        res["m8_from_kernel_merged"] = stage_diff(f"{label} merged-head codes vs plain quant of "
                                                  "the kernel's heads", k_m8, m8.float())
        res["mrs_from_kernel_merged"] = stage_diff(f"{label} merged-head row scales",
                                                   k_mrs, mrs)
        # the proj on the kernel's own codes and scales
        p_out = (xv + q._int8_matmul(keep["m8"].reshape(*shape, a), wp8) * (k_mrs * sp)
                 + bp).to(torch.bfloat16).float()
        res["out_from_kernel_codes"] = stage_diff(f"{label} output vs plain proj on the kernel's "
                                                  "codes", kernel.float(), p_out)
        # plain from the kernel's q, k, v on: its core, codes and proj
        o8, ors = q._quant_rows(own.float())
        from_qkv = (xv + q._int8_matmul(o8, wp8) * (ors * sp) + bp).to(torch.bfloat16).float()
        # plain from the kernel's LayerNorm + quant codes on: its qkv
        # epilogue, the plain core, codes and proj
        l8, lrs = q._quant_rows(attention_core_plain(from_ln, w.heads, torch.bfloat16).float())
        from_codes = (xv + q._int8_matmul(l8, wp8) * (lrs * sp) + bp).to(torch.bfloat16).float()
        res["out_vs_plain_from_kernel_ln_codes_max"] = (
            kernel.float() - from_codes).abs().max().item()
        whole = q.attn_sublayer_int8_plain(x, *ops, num_heads=w.heads).float()
        res["out_vs_plain_max"] = (kernel.float() - whole).abs().max().item()
        print(f"k11 stages: {label} output: max |kernel - plain| {res['out_vs_plain_max']:.6g}, "
              f"max |kernel - plain from the kernel's LayerNorm + quant codes| "
              f"{res['out_vs_plain_from_kernel_ln_codes_max']:.6g}", flush=True)
        row = (b, K11_TRACE_ROW)
        at = {
            "kernel": kernel[row].float(), "plain": whole[row],
            "plain_from_kernel_ln_codes": from_codes[row],
            "plain_from_kernel_qkv": from_qkv[row], "plain_proj_on_kernel_codes": p_out[row],
        }
        worst = int((at["kernel"] - at["plain"]).abs().argmax())
        res[f"row{row}"] = {k: v[worst].item() for k, v in at.items()}
        res[f"row{row}"]["column"] = worst
        print(f"k11 stages: {label} row {row}, its worst column {worst}: "
              f"{res[f'row{row}']}", flush=True)
        out[f"qkv_bias={qkv_bias}"] = res
        del keep, kernel, exact, xn, pos, p_qkv, own, p_merged, whole, p_out, from_qkv, o8, from_ln, from_codes
    print(json.dumps({"k11_stages": out}), flush=True)
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("FAILED: no CUDA device; k11_codes.py runs only on a GPU", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    setup()
    diagnose_k11_codes(torch.device("cuda", 0))
    trace_k11_stages(torch.device("cuda", 0))
    return 0


if __name__ == "__main__":
    sys.exit(main())
