"""Export and import of a compiled network: OpenVINO's
``ExecutableNetwork.export`` / ``IECore.import_network`` (2.0:
``CompiledModel.export_model`` / ``Core.import_model``).

The port's counterpart of ``pyopenvino_tpu/runtime/export.py``.  The JAX
package serializes its traced program as StableHLO; the port runs its graph
eagerly and has no program to serialize, so its artifact holds what
``CompiledNetwork.__init__`` is built from, after every costly load step:

    meta.json      ``format`` "pyopenvino_tpu_torch", a format version, the
                   config (``_config_meta``), the buckets, the io names,
                   shapes and dtypes (``_io_meta``, the JAX artifact's form),
                   the activation scales {node id: scale}, the quantized
                   Consts' ids, the Consts whose bytes model.bin leaves
                   out, stateful networks' variables, and what the IR
                   writer does not keep: the engine's own node attributes
                   (``_opset``) and which Consts are 0-d
    model.xml,     the PREPARED model (after ``prepare_model``: dead nodes
    model.bin      pruned, BN scales and FakeQuantizes folded), written by
                   the port's ``ir/writer.py``, node ids kept.  A Const that
                   only running ops read and whose weight says what it
                   holds (a quantized one: its codes and scales; a float32
                   one in a float32 network) is written as zeros and
                   model.bin deflated, so each weight is held once
    prepared.npz   ``bias_corr`` (each bias's correction)
    weights.npz    the compiled network's weights in ``save_weights``'s form:
                   the JAX artifact's keys, bfloat16 as tagged uint16; a
                   quantized weight's int8 codes and scales are the
                   ``quantized`` that ``prepare_model`` made

Importing parses the model, puts the left-out Consts back from their
weights (a quantized one as its codes times its scales, the value the
compiled network computes with), and builds the ``CompiledNetwork`` on
the device asked for with ``weights.npz`` as its weights (its shape
inference and fusion planning, as for any network).  It runs none of
``prepare_model``'s passes, no quantization, calibration or bias
correction, and needs neither the user's ``.xml``/``.bin`` nor samples.
The imported network runs the same kernels on the same weights, scales
and int8 edges, so its outputs are the exporter's, bit for bit.

A stateful network exports too; its initial state comes from the prepared
graph's ReadValue inits.  A sharded network (``parallel/mesh.py``) exports
its whole weights once and, in meta.json, the JAX artifact's ``mesh``
(axis names, shape, device count), ``w_pspecs`` (each weight's spec) and
``batch_pspec``, and the port's ``spatial_axis``; its import rebuilds an
equally shaped mesh from the devices it is given and places the weights by
those specs, so the imported network runs the exporter's shards.  A
stateful sharded network is refused, as in the JAX package.
"""

from __future__ import annotations

import copy
import dataclasses
import io
import json
import os
import tempfile
import zipfile
from typing import Dict, Sequence

import numpy as np
import torch

from pyopenvino_tpu_torch.config import Backend, Config, QuantMode

FORMAT = "pyopenvino_tpu_torch"
FORMAT_VERSION = 2
# what reading a damaged, truncated or foreign artifact raises: a bad zip, a
# missing member or key, a refused format, unparsable XML, a config field
# this runtime does not have
ARTIFACT_ERRORS = (OSError, EOFError, KeyError, ValueError, TypeError, SyntaxError,
                   zipfile.BadZipFile)


def _npz_bytes(arrays: Dict[str, np.ndarray]) -> bytes:
    buf = io.BytesIO()
    np.savez_compressed(buf, **arrays)
    return buf.getvalue()


def _io_meta(compiled):
    """The JAX artifact's io fields: each input's shape and dtype, the
    outputs' names."""
    infos = {n.name: n.outputs[n.out_port] for n in compiled.model.parameters}
    return {
        "inputs": {name: {"shape": [int(d) for d in info.shape],
                          "dtype": np.dtype(info.dtype).name}
                   for name, info in infos.items()},
        "outputs": [n.name for n in compiled.model.results],
    }


def _config_meta(config: Config):
    cfg = dataclasses.asdict(config)
    cfg["backend"] = config.backend.value
    cfg["quant"] = config.quant.value
    return cfg


def _config_from_meta(cfg) -> Config:
    cfg = dict(cfg)
    cfg["backend"] = Backend(cfg["backend"])
    cfg["quant"] = QuantMode(cfg["quant"])
    cfg["batch_buckets"] = tuple(cfg["batch_buckets"])
    return Config(**cfg)


def _annotations(model, prefix: str = "") -> Dict[str, Dict[str, object]]:
    """{node path: what the IR writer does not keep}, bodies included (path
    ``<id>/<body name>/<id>``): the ``_``-prefixed attributes under
    ``attrs``, and ``scalar`` for a 0-d Const (written with shape "1")."""
    out = {}
    for node in model:
        path = prefix + str(node.id)
        out[path] = {"attrs": {k: v for k, v in node.attrs.items() if k.startswith("_")}}
        if node.const is not None and node.const.ndim == 0:
            out[path]["scalar"] = True
        for bname, sg in (node.subgraphs or {}).items():
            out.update(_annotations(sg.model, f"{path}/{bname}/"))
    return out


def _restore_annotations(model, annotations, prefix: str = ""):
    for node in model:
        path = prefix + str(node.id)
        kept = annotations.get(path, {})
        node.attrs = {**{k: v for k, v in node.attrs.items() if not k.startswith("_")},
                      **kept.get("attrs", {})}
        if kept.get("scalar"):
            node.const = node.const.reshape(())
        for bname, sg in (node.subgraphs or {}).items():
            _restore_annotations(sg.model, annotations, f"{path}/{bname}/")


def export_compiled(compiled, path: str, buckets: Sequence[int] = (8, 32)) -> None:
    """Write ``compiled`` (a CompiledNetwork) into one zip at ``path``.
    ``buckets`` is kept in the metadata as the exporter named it: the
    imported network bakes any batch on demand (``_batched_plan``), as the
    JAX package's shape-polymorphic program serves any batch."""
    from pyopenvino_tpu_torch.ir.writer import serialize_ir
    from pyopenvino_tpu_torch.runtime.compiler import encode_weights

    mesh = getattr(compiled, "mesh", None)
    if mesh is not None and compiled.variables:
        raise NotImplementedError(
            "stateful + sharded export is unsupported (shard_compiled places no variable "
            "state by mesh either); export the unsharded stateful network instead")
    stripped = _weight_only_consts(compiled)
    xml, blob = serialize_ir(_zeroed(compiled.model, stripped))
    meta = {
        "format": FORMAT,
        "format_version": FORMAT_VERSION,
        "config": _config_meta(compiled.config),
        "buckets": sorted({int(b) for b in buckets}),
        "act_scales": {str(k): float(v) for k, v in compiled.act_scales.items()},
        "quantized": sorted(int(cid) for cid in compiled._quantized),
        "weight_only_consts": stripped,
        "stateful": bool(compiled.variables),
        "variables": {
            vid: {"shape": [int(d) for d in var["shape"]],
                  "dtype": np.dtype(var["dtype"]).name,
                  "dynamic_init": bool(var["dynamic_init"])}
            for vid, var in compiled.variables.items()},
        "annotations": _annotations(compiled.model),
        **_io_meta(compiled),
    }
    if mesh is not None:
        meta.update({
            "mesh": {"axis_names": list(mesh.axis_names),
                     "shape": [int(mesh.shape[a]) for a in mesh.axis_names],
                     "num_devices": int(mesh.devices.size)},
            "w_pspecs": {k: list(spec) for k, spec in compiled._w_specs.items()},
            "batch_pspec": list(compiled._batch_pspec),
            "spatial_axis": compiled._spatial_axis,
        })
    with zipfile.ZipFile(path, "w", zipfile.ZIP_STORED) as zf:
        zf.writestr("meta.json", json.dumps(meta, indent=1))
        zf.writestr("model.xml", xml)
        zf.writestr("model.bin", blob,
                    compress_type=zipfile.ZIP_DEFLATED if stripped else zipfile.ZIP_STORED)
        zf.writestr("prepared.npz", _npz_bytes(
            {f"bias_corr.{cid}": np.asarray(corr) for cid, corr in compiled._bias_corr.items()}))
        zf.writestr("weights.npz", _npz_bytes(encode_weights(compiled.weights)))


def _weight_only_consts(compiled) -> list:
    """Ids of the Consts whose bytes the artifact leaves out of model.bin:
    every consumer runs (no folded node or static port reads the value),
    and the compiled weight gives it back, as codes and scales where it is
    quantized, exactly where it is a float32 weight of a float32 network
    with no bias correction."""
    from pyopenvino_tpu_torch.runtime.compiler import STATIC_PORTS

    model, ids = compiled.model, []
    f32 = compiled.compute_dtype == torch.float32
    for nid in sorted(compiled._runtime_consts):
        const = model.nodes[nid].const
        only_runs = all(
            dst not in compiled._folded_nodes and (model.nodes[dst].op_type, dport)
            not in STATIC_PORTS for _, dst, dport in model.out_edges[nid])
        if only_runs and (nid in compiled._quantized or (
                f32 and const.dtype == np.float32 and nid not in compiled._bias_corr)):
            ids.append(int(nid))
    return ids


def _zeroed(model, ids):
    """A copy of ``model`` for the writer, the Consts ``ids`` holding zeros."""
    if not ids:
        return model
    out = copy.copy(model)
    out.nodes = dict(model.nodes)
    for nid in ids:
        node = model.nodes[nid]
        out.nodes[nid] = dataclasses.replace(node, const=np.zeros_like(node.const))
    return out


def _read_meta(zf: zipfile.ZipFile) -> dict:
    """An artifact's meta.json, refused unless the port wrote it in a
    format version this runtime reads."""
    meta = json.loads(zf.read("meta.json"))
    if meta.get("format") != FORMAT:
        raise ValueError(
            f"not a {FORMAT} artifact (format {meta.get('format')!r}); the JAX "
            f"package's .ovtpu files hold StableHLO, which the port cannot run")
    if meta["format_version"] > FORMAT_VERSION:
        raise ValueError(f"artifact format v{meta['format_version']} is newer than "
                         f"this runtime (v{FORMAT_VERSION})")
    return meta


class ImportedNetwork:
    """A network loaded from an artifact: ``network`` is the rebuilt
    CompiledNetwork, ``meta`` the artifact's metadata.  It answers
    ``infer``, ``infer_batch`` (any batch: the network's ``_batched_plan``)
    and ``__call__``, and holds ``weights``, ``mesh`` (a sharded artifact's,
    rebuilt on ``devices``) and a stateful network's ``reset_state`` and
    ``query_state``."""

    def __init__(self, path: str, device="cuda", devices=None, mesh=None):
        from pyopenvino_tpu_torch.ir.xml_parser import parse_ir
        from pyopenvino_tpu_torch.runtime.compiler import CompiledNetwork, decode_weights

        with zipfile.ZipFile(path) as zf:
            meta = _read_meta(zf)
            xml, blob = zf.read("model.xml"), zf.read("model.bin")
            prepared = zf.read("prepared.npz")
            weights = decode_weights(io.BytesIO(zf.read("weights.npz")))
        model = parse_ir(xml.decode("utf-8"), blob)
        _restore_annotations(model, meta["annotations"])
        quantized = {cid: (weights[str(cid)].numpy(),
                           weights[f"{cid}.scale"].float().numpy())
                     for cid in meta["quantized"] if str(cid) in weights}
        for cid in meta["weight_only_consts"]:
            node = model.nodes[cid]
            node.const = (quantized[cid][0].astype(np.float32) * quantized[cid][1]
                          if cid in quantized else weights[str(cid)].numpy().copy())
        with np.load(io.BytesIO(prepared)) as data:
            bias_corr = {int(k.split(".")[1]): data[k] for k in data.files}
        self.meta = meta
        self.network = CompiledNetwork(
            model, _config_from_meta(meta["config"]), device=device,
            quantized=quantized, act_scales={int(k): v for k, v in meta["act_scales"].items()},
            bias_corr=bias_corr, weights=weights)
        if meta.get("mesh"):
            _rebuild_mesh(self.network, meta, device if devices is None else devices, mesh)
        self.input_names = list(meta["inputs"])
        self.output_names = list(meta["outputs"])

    @property
    def weights(self) -> Dict[str, torch.Tensor]:
        return self.network.weights

    @property
    def mesh(self):
        return self.network.mesh

    @property
    def stateful(self) -> bool:
        return bool(self.network.variables)

    def reset_state(self):
        """Every variable back to its init (the prepared graph's)."""
        self.network.reset_state()

    def query_state(self) -> Dict[str, np.ndarray]:
        return self.network.query_state()

    def __call__(self, inputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return self.network(inputs)

    def infer(self, inputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return self.network.infer(inputs)

    def infer_batch(self, inputs: Dict[str, np.ndarray]) -> Dict[str, np.ndarray]:
        return self.network.infer_batch(inputs)


def _rebuild_mesh(network, meta, devices, cfg=None) -> None:
    """Attach to ``network`` a mesh shaped as the exporter's, or as ``cfg``
    (a ``MeshConfig``), on the first of ``devices``
    (``parallel/mesh.py::device_list``: a list, or a device type for its
    defaults), with the exporter's weight specs.  On another shape a
    weight sharded over 'model' keeps its axis where the new model axis
    divides it into more than one part and is replicated elsewhere, as
    ``_weight_pspec`` decides; the spatial axis is kept where the new mesh
    has one."""
    from pyopenvino_tpu_torch.parallel.mesh import (
        MeshConfig, P, attach, build_mesh, check_tp_sp, device_list,
    )

    m = meta["mesh"]
    specs = {k: P(*spec) for k, spec in meta["w_pspecs"].items()}
    spatial_axis = meta.get("spatial_axis")
    if cfg is None:
        cfg = MeshConfig(**dict(zip(m["axis_names"], m["shape"])))
    elif cfg != MeshConfig(**dict(zip(m["axis_names"], m["shape"]))):
        for k, spec in specs.items():
            if "model" in spec:
                size = network.weights[k].shape[spec.index("model")]
                if cfg.model < 2 or size % cfg.model:
                    specs[k] = P()
        spatial_axis = spatial_axis if cfg.spatial > 1 else None
        check_tp_sp(any("model" in s for s in specs.values()), spatial_axis is not None,
                    cfg.model, cfg.spatial)
    n_dev = cfg.data * cfg.model * cfg.spatial
    listed = device_list(devices)
    if len(listed) < n_dev:
        raise ValueError(f"sharded artifact needs {n_dev} devices (mesh {m['axis_names']}="
                         f"{[cfg.data, cfg.model, cfg.spatial]}), have {len(listed)}")
    attach(network, build_mesh(cfg, listed), specs, spatial_axis)
    network._batch_pspec = P(*meta["batch_pspec"])


def import_compiled(path: str, device="cuda", devices=None, mesh=None) -> ImportedNetwork:
    """Load an artifact onto ``device`` (the card unless the caller names
    the CPU).  A sharded artifact's mesh is rebuilt on ``devices`` (by
    default the defaults of ``device``'s type: every visible card, the CPU
    8 times, in a multi-process group the group's); too few raise, as in
    the JAX package.  ``mesh`` (a ``MeshConfig``) places a sharded artifact
    on another shape than the exporter's, the port's own option: the JAX
    artifact is pinned to its shape (``_rebuild_mesh``)."""
    return ImportedNetwork(path, device=device, devices=devices, mesh=mesh)


def write_atomically(compiled, path: str, buckets: Sequence[int] = (8, 32)) -> None:
    """``export_compiled`` into a temporary name beside ``path``, then
    ``os.replace``: a reader in another process sees the whole artifact or
    none."""
    fd, tmp = tempfile.mkstemp(suffix=".tmp", dir=os.path.dirname(os.path.abspath(path)))
    os.close(fd)
    try:
        export_compiled(compiled, tmp, buckets)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
