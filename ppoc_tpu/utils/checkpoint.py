"""Binary checkpointing of the full training state.

Equivalent of save_ppo/load_ppo (src/ppo.cu:585-648): a single binary file
holding the five scalar hyperparameters, buffer dims, the policy (log_std +
mean-net layers), the value net, and all three Adam states INCLUDING the
timestep — so a load resumes optimization bit-for-bit.  The layout mirrors
the reference's field order (hyperparams -> dims -> policy -> V -> 3 Adams;
Adam state flattened in (W0, b0, W1, b1, ...) order as in
create_adam_from_nn, src/adam.cu:25-42) but is versioned, unlike the
reference's raw struct dump.

Version 3 additionally embeds the FULL PPOConfig (JSON) and the trainer's
PRNG key, making the file self-describing: ``Trainer.from_checkpoint(path)``
rebuilds env, nets, optimizers and RNG position from the file alone — parity
with load_ppo reconstructing the whole PPO struct (src/ppo.cu:610-648) —
and an interrupted run resumes bit-for-bit (see tests/test_resume.py).
Version 2 files (no config/key) still load via the template path.

Version 4 extends the layout with a kind tag per trunk so the
mixture-of-experts model family (models/moe.py: router + stacked expert
MLPs) and the recurrent family (models/gru.py: GRU cell + dense head)
serialize alongside dense MLPs; plain-MLP states keep writing
byte-identical version-3 files.  MoE checkpoints always hold the logical
(full-expert) layout, so they are interchangeable between single-device and
expert-parallel (ep_size > 1) trainers.
"""
from __future__ import annotations

import struct
import warnings
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

MAGIC = b"PPOC"
VERSION = 3       # plain dense-MLP trunks
MOE_VERSION = 4   # kind-tagged trunks (dense MLP, mixture-of-experts, GRU)


class Checkpoint(NamedTuple):
    """Everything a checkpoint file holds.  ``cfg``/``key`` are None for
    version-2 files (saved before they were recorded)."""
    hyperparams: Dict[str, float]
    dims: Dict[str, Any]
    state: Any               # algo.ppo.TrainState
    cfg: Optional[Any]       # ppoc_tpu.config.PPOConfig
    key: Optional[jax.Array] # trainer PRNG key at save time
    meta: Optional[Dict[str, Any]] = None  # run metadata (e.g. epochs_done
                               # for elastic resume); rides in the config
                               # JSON blob under the reserved "_meta" key,
                               # so no format bump.  load() always supplies
                               # a fresh dict (None only on hand-built
                               # instances — no shared mutable default)


def _w(f, fmt, *vals):
    f.write(struct.pack("<" + fmt, *vals))


def _r(f, fmt):
    size = struct.calcsize("<" + fmt)
    out = struct.unpack("<" + fmt, f.read(size))
    return out if len(out) > 1 else out[0]


def _write_arr(f, a: np.ndarray):
    a = np.ascontiguousarray(a, dtype=np.float32)
    _w(f, "i", a.size)
    f.write(a.tobytes())


def _read_arr(f, shape=None) -> np.ndarray:
    n = _r(f, "i")
    a = np.frombuffer(f.read(4 * n), dtype=np.float32).copy()
    return a.reshape(shape) if shape is not None else a


def _write_mlp(f, layers: List[Tuple[Any, Any]]):
    _w(f, "i", len(layers))
    for w, b in layers:
        w = np.asarray(w)
        _w(f, "ii", w.shape[0], w.shape[1])
        _write_arr(f, w)
        _write_arr(f, np.asarray(b))


def _read_mlp(f) -> List[Tuple[np.ndarray, np.ndarray]]:
    n = _r(f, "i")
    layers = []
    for _ in range(n):
        fan_in, fan_out = _r(f, "ii")
        w = _read_arr(f, (fan_in, fan_out))
        b = _read_arr(f, (fan_out,))
        layers.append((w, b))
    return layers


def _write_trunk(f, trunk):
    """Version-4 kind-tagged trunk: 0 = dense MLP, 1 = mixture of experts
    (router layer + stacked [E, fan_in, fan_out] expert layers), 2 = GRU
    (cell wx/wh/b + dense head, 3H gates), 3 = LSTM (same layout, 4H
    gates), 4 = causal-attention encoder (embed + pos + blocks + final LN
    + dense head, models/attn.py)."""
    from ppoc_tpu.models.attn import is_attn
    from ppoc_tpu.models.gru import cell_kind, is_rnn
    from ppoc_tpu.models.moe import is_moe

    if is_attn(trunk):
        # kind 5 = kind 4 + the PPG-style auxiliary value head
        # (cfg.aux_value_coeff — algo/recurrent.policy_phase_rnn); written
        # as a trailing extra mlp so kind-4 files stay byte-identical
        _w(f, "i", 5 if "aux_head" in trunk else 4)
        a = trunk["attn"]
        we, be = a["embed"]
        we = np.asarray(we)
        n_heads, hd = np.asarray(a["blocks"][0]["wqkv"]).shape[-2:]
        ff = np.asarray(a["blocks"][0]["ff1"][0]).shape[1]
        _w(f, "iiiiii", we.shape[0], we.shape[1], a["pos"].shape[0],
           n_heads, len(a["blocks"]), ff)
        _write_arr(f, we)
        _write_arr(f, np.asarray(be))
        _write_arr(f, np.asarray(a["pos"]))
        for blk in a["blocks"]:
            for arr in (blk["wqkv"], blk["bqkv"], blk["wo"], blk["bo"],
                        blk["ln1"][0], blk["ln1"][1],
                        blk["ln2"][0], blk["ln2"][1],
                        blk["ff1"][0], blk["ff1"][1],
                        blk["ff2"][0], blk["ff2"][1]):
                _write_arr(f, np.asarray(arr))
        _write_arr(f, np.asarray(a["lnf"][0]))
        _write_arr(f, np.asarray(a["lnf"][1]))
        _write_mlp(f, trunk["head"])
        if "aux_head" in trunk:
            _write_mlp(f, trunk["aux_head"])
        return
    if is_rnn(trunk):
        _w(f, "i", 3 if cell_kind(trunk) == "lstm" else 2)
        cell = trunk["cell"]
        wx = np.asarray(cell["wx"])
        _w(f, "ii", wx.shape[0], wx.shape[1])
        _write_arr(f, wx)
        _write_arr(f, np.asarray(cell["wh"]))
        _write_arr(f, np.asarray(cell["b"]))
        _write_mlp(f, trunk["head"])
        return
    if not is_moe(trunk):
        _w(f, "i", 0)
        _write_mlp(f, trunk)
        return
    _w(f, "i", 1)
    wr, br = trunk["router"]
    wr = np.asarray(wr)
    _w(f, "ii", wr.shape[0], wr.shape[1])
    _write_arr(f, wr)
    _write_arr(f, np.asarray(br))
    experts = trunk["experts"]
    _w(f, "i", len(experts))
    for w, b in experts:
        w = np.asarray(w)
        _w(f, "iii", w.shape[0], w.shape[1], w.shape[2])
        _write_arr(f, w)
        _write_arr(f, np.asarray(b))


def _read_trunk(f):
    kind = _r(f, "i")
    if kind == 0:
        return [(jnp.asarray(w), jnp.asarray(b)) for w, b in _read_mlp(f)]
    if kind in (2, 3):  # 2 = GRU (3H gates), 3 = LSTM (4H gates)
        d_in, hg = _r(f, "ii")
        wx = jnp.asarray(_read_arr(f, (d_in, hg)))
        wh = jnp.asarray(_read_arr(f, (hg // (4 if kind == 3 else 3), hg)))
        b = jnp.asarray(_read_arr(f, (hg,)))
        head = [(jnp.asarray(w), jnp.asarray(bb)) for w, bb in _read_mlp(f)]
        return {"cell": {"wx": wx, "wh": wh, "b": b}, "head": head}
    if kind in (4, 5):  # attention encoder (5 = + PPG aux value head)
        d_in, d, t_max, n_heads, n_layers, ff = _r(f, "iiiiii")
        hd = d // n_heads
        we = jnp.asarray(_read_arr(f, (d_in, d)))
        be = jnp.asarray(_read_arr(f, (d,)))
        pos = jnp.asarray(_read_arr(f, (t_max, d)))
        blocks = []
        for _ in range(n_layers):
            blocks.append({
                "wqkv": jnp.asarray(_read_arr(f, (d, 3, n_heads, hd))),
                "bqkv": jnp.asarray(_read_arr(f, (3, n_heads, hd))),
                "wo": jnp.asarray(_read_arr(f, (d, d))),
                "bo": jnp.asarray(_read_arr(f, (d,))),
                "ln1": (jnp.asarray(_read_arr(f, (d,))),
                        jnp.asarray(_read_arr(f, (d,)))),
                "ln2": (jnp.asarray(_read_arr(f, (d,))),
                        jnp.asarray(_read_arr(f, (d,)))),
                "ff1": (jnp.asarray(_read_arr(f, (d, ff))),
                        jnp.asarray(_read_arr(f, (ff,)))),
                "ff2": (jnp.asarray(_read_arr(f, (ff, d))),
                        jnp.asarray(_read_arr(f, (d,)))),
            })
        lnf = (jnp.asarray(_read_arr(f, (d,))), jnp.asarray(_read_arr(f, (d,))))
        head = [(jnp.asarray(w), jnp.asarray(bb)) for w, bb in _read_mlp(f)]
        trunk = {"attn": {"embed": (we, be), "pos": pos, "blocks": blocks,
                          "lnf": lnf}, "head": head}
        if kind == 5:
            trunk["aux_head"] = [(jnp.asarray(w), jnp.asarray(bb))
                                 for w, bb in _read_mlp(f)]
        return trunk
    if kind != 1:
        raise ValueError(f"unknown trunk kind {kind}")
    d_in, e = _r(f, "ii")
    wr = jnp.asarray(_read_arr(f, (d_in, e)))
    br = jnp.asarray(_read_arr(f, (e,)))
    n = _r(f, "i")
    experts = []
    for _ in range(n):
        ne, fan_in, fan_out = _r(f, "iii")
        w = jnp.asarray(_read_arr(f, (ne, fan_in, fan_out)))
        b = jnp.asarray(_read_arr(f, (ne, fan_out)))
        experts.append((w, b))
    return {"router": (wr, br), "experts": experts}


def _flat_adam(state, params) -> Tuple[np.ndarray, np.ndarray, int]:
    """Flatten an AdamState over a params pytree into (m, v, t) in the
    reference's (W0, b0, W1, b1, ...) order (jax tree flatten order)."""
    m = np.concatenate([np.asarray(x).ravel() for x in jax.tree.leaves(state.m)] or [np.zeros(0, np.float32)])
    v = np.concatenate([np.asarray(x).ravel() for x in jax.tree.leaves(state.v)] or [np.zeros(0, np.float32)])
    return m.astype(np.float32), v.astype(np.float32), int(state.t)


def _unflat_adam(m: np.ndarray, v: np.ndarray, t: int, params):
    from ppoc_tpu.ops.adam import AdamState

    leaves, treedef = jax.tree.flatten(params)
    ms, vs, off = [], [], 0
    for leaf in leaves:
        n = int(np.prod(np.shape(leaf))) if np.ndim(leaf) else 1
        shape = np.shape(leaf)
        ms.append(jnp.asarray(m[off : off + n].reshape(shape)))
        vs.append(jnp.asarray(v[off : off + n].reshape(shape)))
        off += n
    if off != m.size:
        raise ValueError(
            f"Adam state size mismatch: checkpoint has {m.size} elements, "
            f"the parameter tree needs {off}"
        )
    return AdamState(
        m=treedef.unflatten(ms), v=treedef.unflatten(vs), t=jnp.asarray(t, jnp.int32)
    )


def save(path: str, cfg, spec, state, key=None,
         keep_sidecars: tuple = (), meta: Optional[Dict[str, Any]] = None) -> None:
    """Serialize cfg (full config JSON) + env dims + TrainState + trainer
    PRNG ``key`` to ``path``.

    When the C++ host runtime is available the payload is written through
    its checksummed blob container (CRC32 verified on load; the reference's
    raw fwrite dump, src/ppo.cu:585-607, had no integrity check); otherwise
    a plain file with identical payload bytes.

    Stale normalization sidecars (``<path>.obsnorm.npz`` / ``.retnorm.npz``,
    written by HostTrainer.save for norm-wrapped venvs) are removed AFTER a
    successful write so a re-save at the same path by a non-normalizing
    trainer can never leave foreign statistics for serve.load_policy to
    apply.  A norm-wrapped saver passes the suffixes it owns in
    ``keep_sidecars`` and overwrites them atomically itself right after this
    call — deleting those here would open a crash window with a valid
    checkpoint and no statistics.
    """
    import io
    import os

    buf = io.BytesIO()
    _save_stream(buf, cfg, spec, state, key, meta=meta)
    data = buf.getvalue()
    written = False
    try:
        from ppoc_tpu import native
        if native.available():
            native.write_blob(path, data)
            written = True
    except (ImportError, OSError) as e:
        # plain-format fallback is legitimate when the C++ lib is absent or
        # its write fails, but must be VISIBLE so container regressions
        # don't hide
        import warnings

        warnings.warn(
            f"native CRC checkpoint container unavailable ({e!r}); "
            f"writing plain format",
            stacklevel=2,
        )
    if not written:
        with open(path, "wb") as f:
            f.write(data)
    for sidecar in (".obsnorm.npz", ".retnorm.npz"):
        if sidecar not in keep_sidecars and os.path.exists(path + sidecar):
            os.remove(path + sidecar)


def _key_data(key) -> np.ndarray:
    """Raw uint32 words of a PRNG key (handles both old-style uint32 arrays
    and new-style typed keys)."""
    try:
        if jnp.issubdtype(key.dtype, jax.dtypes.prng_key):
            key = jax.random.key_data(key)
    except (AttributeError, TypeError):
        pass
    return np.asarray(jax.device_get(key), np.uint32).reshape(-1)


def _save_stream(f, cfg, spec, state, key=None, version: Optional[int] = None,
                 meta: Optional[Dict[str, Any]] = None) -> None:
    import dataclasses
    import json

    from ppoc_tpu.models.attn import is_attn
    from ppoc_tpu.models.gru import is_rnn
    from ppoc_tpu.models.moe import is_moe

    state = jax.device_get(state)
    if version is None:
        # plain states keep the byte-identical v3 layout; MoE, GRU and
        # attention trunks need the kind-tagged v4 sections
        def _tagged(t):
            return is_moe(t) or is_rnn(t) or is_attn(t)

        tagged = (_tagged(state.policy_params["mlp"])
                  or _tagged(state.v_params))
        version = MOE_VERSION if tagged else VERSION
    f.write(MAGIC)
    _w(f, "i", version)
    if version >= 3:
        # self-description: the FULL config as JSON + the trainer PRNG key,
        # so Trainer.from_checkpoint needs nothing but the file (parity with
        # load_ppo rebuilding the whole PPO, src/ppo.cu:610-648)
        d = dataclasses.asdict(cfg)
        if meta:
            # run metadata (epochs_done, ...) under a reserved key the
            # loader pops back out — the blob stays a valid PPOConfig dict
            d["_meta"] = dict(meta)
        blob = json.dumps(d).encode("utf-8")
        _w(f, "i", len(blob))
        f.write(blob)
        kd = _key_data(key) if key is not None else np.zeros(0, np.uint32)
        _w(f, "i", kd.size)
        f.write(kd.tobytes())
    # hyperparams, reference field order (src/ppo.cu:588-592)
    _w(f, "fffff", cfg.lam, cfg.clip_eps, cfg.ent_coeff, cfg.lr_policy, cfg.lr_v)
    # dims (src/ppo.cu:594-596); "capacity" = steps per fit
    _w(f, "iii", spec.obs_dim, spec.action_dim, cfg.steps_per_fit)
    _w(f, "i", 1 if spec.discrete else 0)
    # policy: log_std then mean net (save_policy, src/policy.cu:201-205)
    log_std = np.asarray(state.policy_params.get("log_std", np.zeros(0, np.float32)))
    _write_arr(f, log_std)
    if version >= MOE_VERSION:
        _write_trunk(f, state.policy_params["mlp"])
        _write_trunk(f, state.v_params)
    else:
        _write_mlp(f, state.policy_params["mlp"])
        # value net
        _write_mlp(f, state.v_params)
    # three Adam states (save order: policy, V, log_std; src/ppo.cu:602-604)
    for st, ps in (
        (state.opt_policy, state.policy_params["mlp"]),
        (state.opt_v, state.v_params),
        (state.opt_log_std, state.policy_params.get("log_std", np.zeros(0))),
    ):
        m, v, t = _flat_adam(st, ps)
        _w(f, "ii", m.size, t)
        _write_arr(f, m)
        _write_arr(f, v)


def _read_blob_python(path: str) -> bytes:
    """Pure-Python reader for the native CRC blob container (int64 length +
    payload + crc32) — a checkpoint written on a machine with the C++
    runtime must load on one without it."""
    import zlib

    with open(path, "rb") as f:
        raw = f.read()
    if len(raw) < 12:
        raise ValueError(f"{path}: too short for a blob container")
    (n,) = struct.unpack("<q", raw[:8])
    if n < 0 or len(raw) < 8 + n + 4:
        raise ValueError(f"{path}: truncated blob container")
    payload = raw[8 : 8 + n]
    (crc,) = struct.unpack("<I", raw[8 + n : 12 + n])
    if (zlib.crc32(payload) & 0xFFFFFFFF) != crc:
        raise IOError(f"{path}: CRC mismatch")
    return payload


def adapt_to_template(state, template):
    """Forward-compatibility shims applied before template validation.

    Attention positional-table GROWTH: a checkpoint whose ``pos`` table is
    shorter than the live template's (same width) pads with zero rows —
    the window-extension load (``Trainer.from_checkpoint(...,
    rollout_len=longer)``), the mechanism behind the recall window-doubling
    curriculum (examples/recall_xl_curriculum.py): each phase trains with a
    RIGHT-SIZED window (rollouts pay only their own cache length) and the
    next phase's trainer grows the table on load.  New rows start at zero
    (positions never attended yet; the embedding stream still carries
    content, fine-tuning trains them) with zero Adam moments.  The
    original one-row case (the V(s') decode slot added after the first
    kind-4 checkpoints) is subsumed.  The pad targets the ``pos`` leaf BY
    KEY — the Adam moment trees mirror the trunk structure — so no other
    row-short leaf can be silently padded.
    """
    from ppoc_tpu.models.attn import is_attn

    def grow(tree, n_pad):
        if not (isinstance(tree, dict) and "attn" in tree):
            return tree
        a = dict(tree["attn"])
        a["pos"] = jnp.pad(jnp.asarray(a["pos"]), ((0, n_pad), (0, 0)))
        return dict(tree, attn=a)

    def pad_rows(trunk, tpl):
        """-> rows to grow (0 = nothing to do; growth only, never shrink)."""
        if not (is_attn(trunk) and is_attn(tpl)):
            return 0
        pos, tp = trunk["attn"]["pos"], tpl["attn"]["pos"]
        if pos.shape[-1] == tp.shape[-1] and pos.shape[0] < tp.shape[0]:
            return tp.shape[0] - pos.shape[0]
        return 0

    n_pol = pad_rows(state.policy_params["mlp"],
                     template.policy_params["mlp"])
    n_v = pad_rows(state.v_params, template.v_params)
    if not (n_pol or n_v):
        return state
    if max(n_pol, n_v) > 1:
        # More than the one-row decode slot means a genuine window change:
        # intentional curriculum loads can silence this, config mistakes
        # (short-window checkpoint into a much longer-window trainer) surface.
        old = template.policy_params["mlp"]["attn"]["pos"].shape[0] \
            - max(n_pol, n_v)
        new = template.policy_params["mlp"]["attn"]["pos"].shape[0]
        warnings.warn(
            f"growing attention positional table from {old} to {new} rows "
            "(zero-initialized, untrained positions) — expected for a "
            "window-extension curriculum load, a mistake otherwise",
            UserWarning, stacklevel=2)
    pol = dict(state.policy_params)
    pol["mlp"] = grow(state.policy_params["mlp"], n_pol) if n_pol \
        else state.policy_params["mlp"]
    v_trunk = grow(state.v_params, n_v) if n_v else state.v_params
    opt_policy = state.opt_policy._replace(
        m=grow(state.opt_policy.m, n_pol) if n_pol else state.opt_policy.m,
        v=grow(state.opt_policy.v, n_pol) if n_pol else state.opt_policy.v)
    opt_v = state.opt_v._replace(
        m=grow(state.opt_v.m, n_v) if n_v else state.opt_v.m,
        v=grow(state.opt_v.v, n_v) if n_v else state.opt_v.v)
    return state._replace(policy_params=pol, v_params=v_trunk,
                          opt_policy=opt_policy, opt_v=opt_v)


def _check_template(state, template) -> None:
    """Shape/structure validation so a mismatched checkpoint fails loudly at
    load time instead of as a cryptic XLA shape error inside the jit."""
    ls, ts = jax.tree.leaves(state), jax.tree.leaves(template)
    if len(ls) != len(ts):
        raise ValueError(
            f"checkpoint structure mismatch: {len(ls)} leaves vs "
            f"{len(ts)} in the live training state"
        )
    for a, b in zip(ls, ts):
        if np.shape(a) != np.shape(b):
            raise ValueError(
                f"checkpoint shape mismatch: {np.shape(a)} vs live "
                f"{np.shape(b)} — was it saved with a different hidden/env "
                f"configuration?"
            )


def load(path: str, template=None) -> Checkpoint:
    """Load a checkpoint.  Returns a :class:`Checkpoint` (hyperparams, dims,
    state, cfg, key) — cfg/key are None for version-2 files.

    Accepts both containers: the CRC-checked native blob (detected by its
    length header) and the plain file (starts directly with the magic).
    ``template`` (a live TrainState) enables shape validation."""
    import io

    with open(path, "rb") as fh:
        head = fh.read(4)
    if head == MAGIC:
        with open(path, "rb") as fh:
            return _load_stream(fh, template)
    try:
        from ppoc_tpu import native
        if native.available():
            data = native.read_blob(path)
        else:
            data = _read_blob_python(path)
    except ImportError:
        data = _read_blob_python(path)
    return _load_stream(io.BytesIO(data), template)


def _load_stream(f, template=None) -> Checkpoint:
    import json

    from ppoc_tpu.algo.ppo import TrainState

    magic = f.read(4)
    if magic != MAGIC:
        raise ValueError(f"not a ppoc_tpu checkpoint: bad magic {magic!r}")
    version = _r(f, "i")
    if version not in (2, VERSION, MOE_VERSION):
        raise ValueError(f"unsupported checkpoint version {version}")
    cfg = key = None
    meta: Dict[str, Any] = {}
    if version >= 3:
        from ppoc_tpu.config import PPOConfig

        blob = f.read(_r(f, "i"))
        d = json.loads(blob.decode("utf-8"))
        for tup_field in ("hidden", "obs_loc", "obs_scale"):
            if tup_field in d:
                d[tup_field] = tuple(d[tup_field])
        meta = d.pop("_meta", {})
        from ppoc_tpu.config import KERNEL_BACKENDS

        if d.get("kernel_backend") not in KERNEL_BACKENDS:
            # files from versions with other backend values: the backend
            # is an execution choice, not part of the trained state
            d["kernel_backend"] = PPOConfig.kernel_backend
        cfg = PPOConfig(**d)
        nk = _r(f, "i")
        if nk:
            key = jnp.asarray(
                np.frombuffer(f.read(4 * nk), dtype=np.uint32).copy()
            )
    lam, clip_eps, ent_coeff, lr_policy, lr_v = _r(f, "fffff")
    obs_dim, action_dim, capacity = _r(f, "iii")
    discrete = bool(_r(f, "i"))
    log_std = _read_arr(f)
    if version >= MOE_VERSION:
        mu_layers = _read_trunk(f)
        v_layers = _read_trunk(f)
    else:
        mu_layers = [(jnp.asarray(w), jnp.asarray(b)) for w, b in _read_mlp(f)]
        v_layers = [(jnp.asarray(w), jnp.asarray(b)) for w, b in _read_mlp(f)]
    policy_params: Dict[str, Any] = {"mlp": mu_layers}
    if not discrete:
        policy_params["log_std"] = jnp.asarray(log_std)
    adams = []
    for ps in (mu_layers, v_layers, policy_params.get("log_std", jnp.zeros(0))):
        _, t = _r(f, "ii")
        m = _read_arr(f)
        v = _read_arr(f)
        adams.append(_unflat_adam(m, v, t, ps))
    state = TrainState(
        policy_params=policy_params,
        v_params=v_layers,
        opt_policy=adams[0],
        opt_v=adams[1],
        opt_log_std=adams[2],
    )
    hp = dict(lam=lam, clip_eps=clip_eps, ent_coeff=ent_coeff,
              lr_policy=lr_policy, lr_v=lr_v)
    dims = dict(obs_dim=obs_dim, action_dim=action_dim, capacity=capacity,
                discrete=discrete)
    if template is not None:
        _check_template(state, template)
    return Checkpoint(hp, dims, state, cfg, key, meta)
