"""Generate a scaled template by midpoint subdivision (counterpart of
meshvae_tpu/tools/make_scaled_template.py, one process, no barrier):

    python -m meshvae_tpu_torch.tools.make_scaled_template [src.obj] [dst.obj]

The train driver calls ensure_template() so that
``python -m meshvae_tpu_torch.train -c files/scaled80k.cfg`` works from a
clean checkout: a missing templateNk.obj regenerates from its vendored
template5k sibling (deterministic midpoint subdivision and RCM relabeling).
"""
import os
import sys

from ..mesh.io import load_obj, save_obj
from ..mesh.subdivide import subdivide_to_target

# Generator version marker (leading OBJ comment), the JAX package's: v2 =
# RCM-relabeled vertex order (mesh/subdivide.reorder_vertices_rcm). v1
# files (no "v2", midpoints appended last) shatter block locality, so they
# are regenerated in place.
_MARKER = "meshvae_tpu scaled template v2 (rcm)"


def _generated_version(path: str) -> int | None:
    """Generator version of an existing template: 2 for current files, 1
    for marked older ones, None for files we cannot attribute
    (user-provided, or generated before markers existed), which are never
    overwritten."""
    try:
        with open(path, "r") as fp:
            first = fp.readline()
    except OSError:
        return None
    if first.startswith("#") and "meshvae_tpu scaled template" in first:
        return 2 if "v2" in first else 1
    return None


def ensure_template(path: str) -> None:
    """Generate a missing scaled template. A path of the form
    .../templateNk.obj with a template5k.obj sibling is produced by
    repeated midpoint subdivision (5k -> 20k -> 80k: x4 vertices per
    round); only 5 * 4^m thousand is reachable, and any other N raises
    unless the file exists already. Any other path is left alone."""
    name = os.path.basename(path)
    if not (name.startswith("template") and name.endswith("k.obj")):
        return
    src = os.path.join(os.path.dirname(path), "template5k.obj")
    if not os.path.exists(src) or os.path.abspath(src) == os.path.abspath(path):
        return
    try:
        target_k = int(name[len("template"):-len("k.obj")])
    except ValueError:
        return
    reachable = 5
    while reachable < target_k:
        reachable *= 4
    if reachable != target_k:
        if os.path.exists(path):
            return
        raise ValueError(
            f"cannot generate {name}: midpoint subdivision of template5k "
            f"reaches only 5*4^m vertices (5k, 20k, 80k, ...), not "
            f"{target_k}k — provide the template file explicitly")
    exists = os.path.exists(path)
    version = _generated_version(path) if exists else None
    if exists and version is None:
        print(f"note: {path} exists without a generator marker; if it was "
              f"machine-generated before RCM relabeling, delete it to "
              f"regenerate with the block-local vertex order",
              file=sys.stderr)
    if not exists or (version is not None and version < 2):
        mesh = subdivide_to_target(load_obj(src), target_k)
        tmp = path + f".tmp{os.getpid()}"
        save_obj(tmp, mesh.v, mesh.f, comment=_MARKER)
        os.replace(tmp, path)
        print(f"generated {path}: {mesh.num_vertices} vertices "
              f"(midpoint subdivision of {src})")


def main():
    src = sys.argv[1] if len(sys.argv) > 1 else "./template/template5k.obj"
    dst = sys.argv[2] if len(sys.argv) > 2 else "./template/template20k.obj"
    mesh = subdivide_to_target(load_obj(src), target_k=20)
    os.makedirs(os.path.dirname(dst) or ".", exist_ok=True)
    save_obj(dst, mesh.v, mesh.f, comment=_MARKER)
    print(f"wrote {dst}: {mesh.num_vertices} vertices, "
          f"{mesh.num_faces} faces")


if __name__ == "__main__":
    main()
