"""Small cells for the CPU tests: a BENCHMARK.json cell with its
configuration cut to a test size (the widths of the protocol kept)."""

from portbench import manifest

STEPS = 128


def small_cell(name: str, **traffic) -> "manifest.Cell":
    cell = manifest.Cell(name)
    cell.config["steps"] = STEPS
    cell.traffic.update(traffic)
    return cell


def exchange_left_out(rank, *args):
    """The sharded cell's rank with the four-step NTT's exchange between
    ranks left out: each equal all-to-all keeps the rank's own rows."""
    from starks_tpu_torch.parallel import mesh as pmesh
    from portbench.drivers import sharded
    real = pmesh.Mesh.all_to_all_single

    def local(self, x, in_splits=None, out_splits=None, **kw):
        if in_splits is None and out_splits is None:
            return x.clone()
        return real(self, x, in_splits, out_splits, **kw)

    pmesh.Mesh.all_to_all_single = local
    return sharded.rank_main(rank, *args)


def rank_loading_jax(rank, *args):
    """The sharded cell's rank with a module named `jax` loaded in it."""
    import sys
    import types
    from portbench.drivers import sharded
    sys.modules.setdefault("jax", types.ModuleType("jax"))
    return sharded.rank_main(rank, *args)
