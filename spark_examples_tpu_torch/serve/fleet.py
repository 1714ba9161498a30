"""Fleet manifest + assembly: ``serve --fleet fleet.json``.

The manifest is the route registry — one JSON file mapping route names
to model paths and panel sources, plus the pool budget the warm panels
share::

    {
      "budget_mb": 256,                 // warm panel pool budget
      "max_batch": 8,                   // optional, ServeConfig default
      "block_variants": 8192,           // optional staging granularity
      "routes": [
        {"name": "eur-panel", "model": "eur.npz",
         "source": "store:/data/eur.store"},
        {"name": "afr-panel", "model": "afr.npz",
         "source": "packed", "path": "/data/afr_packed",
         "block_variants": 4096, "topk": true}
      ]
    }

A route with ``"topk": true`` additionally answers ``POST /neighbors``
(exact query-vs-panel nearest neighbors through the model metric's
pairwise finalize) — validated at load: the model must carry a
pairable metric (kernels.PairSpec), so a capability the model cannot
honor dies at startup, not on the first request.

``source`` takes the same spellings as the CLI ``--source`` family
(``store:<dir>`` shorthand included — IngestConfig normalizes it);
panels stage lazily through whatever read path the source arms (store
readahead, decode cache, verified reads). Replica groups run one fleet
process per host against the SAME content-addressed store directories
— the store is the shared cold tier, and client-side request hedging
between replicas lives in serve/loadgen.py.

Malformed manifests die as :class:`FleetFormatError` with the offending
route/field named (the load_model/StoreFormatError convention) — a
fleet process must refuse a half-valid registry at startup, not 404 on
its first unlucky request. The messages are the JAX package's. A
manifest's ``slos`` (per-route p99 and availability objectives) are
parsed by ``fleet/slo.py::parse_slos`` into the specs the fleet
controller evaluates as burn rates (``ControllerConfig.slos``); the
serve process itself only validates them.
"""

from __future__ import annotations

import dataclasses
import json

import torch

from spark_examples_tpu_torch.core.config import (
    PRIORITY_CLASSES,
    IngestConfig,
    ServeConfig,
)
from spark_examples_tpu_torch.pipelines import project as P
from spark_examples_tpu_torch.pipelines.runner import build_source
from spark_examples_tpu_torch.serve import engine as E
from spark_examples_tpu_torch.serve.pool import PanelPool
from spark_examples_tpu_torch.serve.router import (
    FleetRouter,
    Route,
    _close_source,
)


class FleetFormatError(ValueError):
    """A fleet manifest that cannot be safely interpreted — always with
    the offending route/field named."""


@dataclasses.dataclass(frozen=True)
class RouteSpec:
    """One validated manifest route entry."""

    name: str
    model: str
    source: str
    path: str | None = None
    block_variants: int | None = None
    topk: bool = False


@dataclasses.dataclass(frozen=True)
class FleetManifest:
    routes: tuple[RouteSpec, ...]
    budget_mb: float | None = None
    max_batch: int | None = None
    block_variants: int | None = None
    slos: tuple = ()

    @classmethod
    def parse(cls, doc: dict, origin: str = "<manifest>") -> "FleetManifest":
        if not isinstance(doc, dict):
            raise FleetFormatError(
                f"fleet manifest {origin}: expected a JSON object, got "
                f"{type(doc).__name__}"
            )
        raw_routes = doc.get("routes")
        if not isinstance(raw_routes, list) or not raw_routes:
            raise FleetFormatError(
                f"fleet manifest {origin}: 'routes' must be a non-empty "
                "list of route objects"
            )
        specs = []
        seen: set[str] = set()
        for i, r in enumerate(raw_routes):
            if not isinstance(r, dict):
                raise FleetFormatError(
                    f"fleet manifest {origin}: routes[{i}] is not an "
                    "object"
                )
            for field in ("name", "model", "source"):
                if not isinstance(r.get(field), str) or not r[field]:
                    raise FleetFormatError(
                        f"fleet manifest {origin}: routes[{i}] is "
                        f"missing required string field {field!r} "
                        "(name = the route's address, model = the "
                        ".npz from pcoa/pca --save-model, source = the "
                        "panel source, e.g. store:<dir>)"
                    )
            if r["name"] in seen:
                raise FleetFormatError(
                    f"fleet manifest {origin}: duplicate route name "
                    f"{r['name']!r}"
                )
            seen.add(r["name"])
            unknown = set(r) - {"name", "model", "source", "path",
                                "block_variants", "topk"}
            if unknown:
                raise FleetFormatError(
                    f"fleet manifest {origin}: routes[{i}] "
                    f"({r['name']!r}) has unknown field(s) "
                    f"{sorted(unknown)}"
                )
            if not isinstance(r.get("topk", False), bool):
                raise FleetFormatError(
                    f"fleet manifest {origin}: routes[{i}] "
                    f"({r['name']!r}) topk={r['topk']!r} — expected "
                    "true/false"
                )
            specs.append(RouteSpec(
                name=r["name"], model=r["model"], source=r["source"],
                path=r.get("path"),
                block_variants=r.get("block_variants"),
                topk=r.get("topk", False),
            ))
        unknown_top = set(doc) - {"routes", "budget_mb", "max_batch",
                                  "block_variants", "slos"}
        if unknown_top:
            raise FleetFormatError(
                f"fleet manifest {origin}: unknown top-level field(s) "
                f"{sorted(unknown_top)}"
            )
        # Scalar fields type-checked HERE: a string budget must die as
        # the promised FleetFormatError at load, not as a TypeError
        # from deep inside pool construction.
        for field, kind, lo in (("budget_mb", (int, float), 0.0),
                                ("max_batch", (int,), 1),
                                ("block_variants", (int,), 1)):
            value = doc.get(field)
            if value is None:
                continue
            if (isinstance(value, bool) or not isinstance(value, kind)
                    or value < lo):
                raise FleetFormatError(
                    f"fleet manifest {origin}: {field}={value!r} — "
                    f"expected a number >= {lo}"
                )
        for i, spec in enumerate(specs):
            bv = spec.block_variants
            if bv is not None and (isinstance(bv, bool)
                                   or not isinstance(bv, int) or bv < 1):
                raise FleetFormatError(
                    f"fleet manifest {origin}: routes[{i}] "
                    f"({spec.name!r}) block_variants={bv!r} — expected "
                    "an integer >= 1"
                )
        slos: tuple = ()
        if doc.get("slos") is not None:
            from spark_examples_tpu_torch.fleet import slo as SLO

            def _err(msg: str) -> FleetFormatError:
                return FleetFormatError(
                    f"fleet manifest {origin}: {msg}")

            slos = SLO.parse_slos(doc["slos"], seen, error=_err)
        return cls(
            routes=tuple(specs),
            budget_mb=doc.get("budget_mb"),
            max_batch=doc.get("max_batch"),
            block_variants=doc.get("block_variants"),
            slos=slos,
        )

    @classmethod
    def load(cls, path: str) -> "FleetManifest":
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            raise FleetFormatError(
                f"fleet manifest {path!r} is not readable JSON ({e})"
            ) from None
        return cls.parse(doc, origin=repr(path))


def build_route(spec: RouteSpec, ingest_defaults: IngestConfig,
                default_block_variants: int, device="cuda") -> Route:
    """One manifest entry -> a loaded :class:`Route`: model loaded,
    validated and installed on ``device`` (the router's), panel identity
    checked against a freshly built source (cheap for store-backed
    panels — the manifest answers without touching chunks), n_variants
    probed when the source knows it."""
    ctx = E.ModelContext(P.load_model(spec.model), device)
    if ctx.device.type == "cuda":
        # The model's statistics were copied on this thread's stream;
        # the router's worker reads them on its own.
        torch.cuda.synchronize(ctx.device)
    if spec.topk:
        try:
            E.check_topkable(ctx.model)
        except ValueError as e:
            raise FleetFormatError(
                f"fleet manifest: route {spec.name!r} declares the "
                f"'topk' capability its model cannot honor — {e}"
            ) from None
    panel_cfg = dataclasses.replace(
        ingest_defaults, source=spec.source, path=spec.path,
        block_variants=(spec.block_variants or default_block_variants),
    )

    def panel_source_fn():
        return build_source(panel_cfg, ctx.device.type)

    src = panel_source_fn()
    try:
        P.check_reference_panel(ctx.model, src)
        n_variants = getattr(src, "n_variants", None)
        n_variants = int(n_variants) if n_variants else None
    finally:
        _close_source(src)
    return Route(
        name=spec.name,
        ctx=ctx,
        panel_source_fn=panel_source_fn,
        block_variants=panel_cfg.block_variants,
        n_variants=n_variants,
        topk=spec.topk,
    )


def build_fleet(manifest: FleetManifest, cfg: ServeConfig,
                ingest_defaults: IngestConfig | None = None,
                block_variants: int | None = None,
                device="cuda") -> FleetRouter:
    """Manifest + ServeConfig -> a ready (not yet started) router on
    ``device`` (the card by default; raises where there is none).

    Precedence for shared knobs: manifest value, else ServeConfig /
    the caller's ingest defaults. The pool budget is
    ``manifest.budget_mb`` or ``cfg.fleet_budget_mb``."""
    ingest_defaults = ingest_defaults or IngestConfig()
    budget_mb = (manifest.budget_mb if manifest.budget_mb is not None
                 else cfg.fleet_budget_mb)
    default_bv = (manifest.block_variants or block_variants
                  or ingest_defaults.block_variants)
    router = FleetRouter(
        pool=PanelPool(int(budget_mb * 1e6)),
        max_batch=manifest.max_batch or cfg.max_batch,
        max_linger_s=cfg.max_linger_ms / 1e3,
        cache_entries=cfg.cache_entries,
        queue_bounds={
            PRIORITY_CLASSES[0]: cfg.queue_interactive,
            PRIORITY_CLASSES[1]: cfg.queue_batch,
        },
        class_deadlines_s={
            PRIORITY_CLASSES[0]: cfg.deadline_interactive_ms / 1e3,
            PRIORITY_CLASSES[1]: cfg.deadline_batch_ms / 1e3,
        },
        drain_timeout_s=cfg.drain_timeout_s,
        device=device,
    )
    for spec in manifest.routes:
        router.add_route(
            build_route(spec, ingest_defaults, default_bv, router.device))
    return router
