#!/usr/bin/env python3
"""Break kernels G and H of a checkout down on one NVIDIA GPU, one suspect
taken away at a time.

    python scripts/layout_breakdown_torch.py --tree <checkout>

On chip_smoke.py phases 39 and 40's inputs (the inputs of
compare_tree_torch.py's ``layout`` group), for the checkout's
``threedgrut_tpu_torch`` as it stood before G's and H's redesign
(commit 25275ac and earlier: the C entry points this script calls take
H's aggregates and carries as two workspaces sized by ``fill_blocks``):

- each wrapper call by CUDA events and by device time, in all and by
  kernel (torch.profiler), and its kernels alone: the C entry point called
  through ctypes on buffers allocated once (no tensor checks, no
  allocation, no workspace query);
- the segmented fill's negative-slot check alone (``int(row_slots.min())``);
- variants of the checkout's ``csrc/expand_rows.cu`` and ``csrc/fill.cu``,
  each built from the source with one edit and called like the kernels
  alone: G without its per-slot binary search (each slot's source guessed
  from its position, one load of ends), G with its search and no writes,
  G and H dividing by a compile-time width; H's write pass with 32-bit
  index math. A variant's edit names the lines it replaces; where the
  checkout's source lacks them (a later design), the variant is reported
  as not applicable. Variants compute wrong outputs: they are timed, not
  checked.

Prints one line per measurement and a JSON line of all of them with the
card's ``nvidia-smi`` name and power limit. Needs a CUDA device.
"""

import argparse
import ctypes
import json
import os
import subprocess
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
P, I = ctypes.c_void_p, ctypes.c_int

# variant -> (library, [(text of the checkout's source, its replacement)])
VARIANTS = {
    "g_no_search": ("expand_rows", [(
        "int lo = 0, hi = n_src;  // first k with starts[k] > l",
        "int lo = min(n_src, static_cast<int>(l * n_src / length) + 1), "
        "hi = lo;")]),
    "g_search_only": ("expand_rows", [(
        "for (int e0 = 0; e0 < n_elems; e0 += 32) {",
        "for (int e0 = 0; src == -2 && e0 < n_elems; e0 += 32) {")]),
    "g_const_width": ("expand_rows", [(
        "const int slot = min(e / width, 31);",
        "const int slot = min(e / KW, 31);")]),
    "h_write_32bit": ("fill", [(
        "const int64_t n_elems = static_cast<int64_t>(n_slots) * width;",
        "const int n_elems = n_slots * width;"), (
        "for (int64_t e = threadIdx.x; e < n_elems; e += kThreads) {\n"
        "    const int slot = static_cast<int>(e / width);\n"
        "    const int c = static_cast<int>(e - static_cast<int64_t>(slot)"
        " * width);",
        "for (int e = threadIdx.x; e < n_elems; e += kThreads) {\n"
        "    const int slot = e / width;\n"
        "    const int c = e - slot * width;")]),
    "h_const_width": ("fill", [(
        "const int slot = static_cast<int>(e / width);",
        "const int slot = static_cast<int>(e / KW);")]),
}


def build_variant(build, tree, name, width):
    """ctypes library of VARIANTS[name] (KW = width), or None where the
    tree's source lacks the lines it edits."""
    lib, edits = VARIANTS[name]
    csrc = os.path.join(tree, "threedgrut_tpu_torch", "csrc")
    with open(os.path.join(csrc, f"{lib}.cu")) as f:
        src = f.read()
    for old, new in edits:
        if old not in src:
            return None
        src = src.replace(old, new)
    out = os.path.join(REPO, "build", "layout_breakdown")
    os.makedirs(out, exist_ok=True)
    cu = os.path.join(out, f"{name}_{width}.cu")
    with open(cu, "w") as f:
        f.write(src)
    so = cu[:-3] + ".so"
    subprocess.run([build.nvcc_path()] + build._flags(lib) + [
        f"-DKW={width}", "-I", csrc, "-o", so, cu], check=True)
    return ctypes.CDLL(so)


def bind(lib):
    """Set the argtypes of the C entry points of kernels G and H in lib."""
    for fn, args in (("expand_rows_launch", [P, P, P, I, I, I, P, P]),
                     ("fill_launch", [P, P, I, I, P, P, P, P]),
                     ("fill_rows_launch", [P, P, I, I, I, P, P, P, P, P]),
                     ("fill_blocks", [I])):
        if hasattr(lib, fn):
            getattr(lib, fn).argtypes = args
            getattr(lib, fn).restype = I
    return lib


def kernel_call(lib, inputs, label, dev):
    """A call of lib's C entry point on the arguments of inputs[label], on
    buffers allocated here once."""
    stream = torch.cuda.current_stream(dev).cuda_stream
    if label.startswith("g_"):
        rows, starts, ends, length = inputs[label][1]
        out = torch.empty((length, rows.shape[1]), device=dev)
        return lambda: lib.expand_rows_launch(
            rows.data_ptr(), starts.data_ptr(), ends.data_ptr(),
            rows.shape[0], rows.shape[1], length, out.data_ptr(), stream)
    vals, marked = inputs["h_forward"][1]
    length, d = vals.shape
    out = torch.empty_like(vals)
    nb = max(lib.fill_blocks(length), 1)
    agg, carry, sel = (torch.empty(k, dtype=torch.int32, device=dev)
                       for k in (nb, nb, length))
    if label == "h_forward":
        return lambda: lib.fill_launch(
            vals.data_ptr(), marked.data_ptr(), length, d, agg.data_ptr(),
            carry.data_ptr(), out.data_ptr(), stream)
    row_vals, slots, _ = inputs["h_segmented"][1]
    return lambda: lib.fill_rows_launch(
        row_vals.data_ptr(), slots.data_ptr(), row_vals.shape[0], length, d,
        sel.data_ptr(), agg.data_ptr(), carry.data_ptr(), out.data_ptr(),
        stream)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=REPO,
                    help="the checkout whose kernels G and H to break down")
    tree = os.path.abspath(ap.parse_args().tree)
    if not torch.cuda.is_available():
        raise SystemExit("layout_breakdown_torch.py: needs a CUDA device")
    sys.path[:0] = [tree, HERE]
    import compare_tree_torch as ct
    import threedgrut_tpu_torch
    from threedgrut_tpu_torch.ops.cuda import build

    print(f"measuring {os.path.dirname(threedgrut_tpu_torch.__file__)}",
          flush=True)
    cs = ct.smoke()
    dev = torch.device("cuda:0")
    libs = {k: bind(v) for k, v in build.load_all(
        ["expand_rows", "fill"]).items()}
    inputs = ct.layout_inputs(cs, dev)
    res = {}

    def record(key, fn):
        with torch.no_grad():
            total, by_kernel = cs.device_ms(fn, 20, by_kernel=True)
            res[key] = dict(ms=cs.cuda_ms(fn, 20), device_ms=total,
                            device_by_kernel=by_kernel)
        print(f"{key}: {res[key]['ms']:.4f} ms, device {total:.4f} ("
              + ", ".join(f"{n[:32]} {t:.4f}" for n, t in by_kernel.items())
              + ")", flush=True)

    for label, (fn, args) in inputs.items():
        record(f"{label}_wrapper", lambda f=fn, a=args: f(*a))
    for label in inputs:
        lib = libs["expand_rows" if label.startswith("g_") else "fill"]
        record(f"{label}_alone", kernel_call(lib, inputs, label, dev))
    slots = inputs["h_segmented"][1][1]
    res["h_check"] = dict(ms=cs.cuda_ms(lambda: int(slots.min()), 20),
                          host_ms=cs.host_ms(lambda: int(slots.min()), 20))
    print(f"h_check: {res['h_check']}", flush=True)
    widths = {"g_pairs": inputs["g_pairs"][1][0].shape[1],
              "g_tiles": inputs["g_tiles"][1][0].shape[1],
              "h_forward": inputs["h_forward"][1][0].shape[1]}
    for name in VARIANTS:
        labels = (["g_pairs", "g_tiles"] if name.startswith("g_")
                  else ["h_forward", "h_segmented"])
        for label in labels:
            lib = build_variant(build, tree, name,
                                widths.get(label, widths["h_forward"]))
            key = f"{label}_{name}"
            if lib is None:
                res[key] = "not applicable"
                print(f"{key}: not applicable", flush=True)
                continue
            record(key, kernel_call(bind(lib), inputs, label, dev))
    card = cs.nvidia_smi_line()
    print(card)
    print(json.dumps({"tree": tree, "results": res, "card": card}))


if __name__ == "__main__":
    main()
