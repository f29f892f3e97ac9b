"""Console entry points mirroring the reference's per-stage binaries
(apps/DensifyPointCloud etc.), as ``openmvs_tpu/apps.py`` does for the JAX
package: each forwards to the port's CLI with the stage subcommand
pre-applied, so `omvs-torch-densify scene.mvs` behaves like
`python -m openmvs_tpu_torch densify scene.mvs`."""
import sys


def _run(cmd: str) -> None:
    from openmvs_tpu_torch.__main__ import main

    main([cmd] + sys.argv[1:])


def densify_point_cloud() -> None:
    _run("densify")


def reconstruct_mesh() -> None:
    _run("mesh")


def refine_mesh() -> None:
    _run("refine")


def texture_mesh() -> None:
    _run("texture")


def transform_scene() -> None:
    _run("transform")


def viewer() -> None:
    _run("view")
