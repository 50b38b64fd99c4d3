"""The JAX reference's inputs to one of its jitted pipeline steps, taken from
a run of its SfMPipeline, and the same inputs as the port's arguments.

`capture` records the arguments of the calls it is asked for and stops the
run; `step_args` and `merge_args` turn a registration step's
(`_register_adjust_step`) and a merge attempt's (`_merge_attempt_step`)
arguments into keyword arguments of the port's `register_adjust_step` and
`merge_attempt_step`. Imported by tools/seed_parity.py (`ring-step`,
`merge-step`) and tests/test_torch_ring.py; needs JAX and torch.
"""
import numpy as np

STATE_FIELDS = (
    "points_xyz", "points_rgb", "points_valid", "track_feat", "feat_to_point",
    "cameras", "camera_valid", "focal", "n_points",
)


class _Captured(Exception):
    pass


def capture(module, name, run, pick, n_wanted):
    """Call `run()` with `module.<name>` replaced by a recorder. The n-th
    call (1-based) is kept under `pick(n, args)` unless that is None or
    already held, and the run stops once `n_wanted` calls are held; a
    RuntimeError of the run itself is returned, not raised. The function
    is put back in every case. Returns (the function, {key: args}, the
    run's RuntimeError or None)."""
    fn = getattr(module, name)
    got, calls = {}, [0]

    def recorder(*args):
        calls[0] += 1
        key = pick(calls[0], args)
        if key is not None and key not in got:
            got[key] = args
            if len(got) == n_wanted:
                raise _Captured
        return fn(*args)

    setattr(module, name, recorder)
    err = None
    try:
        run()
    except _Captured:
        pass
    except RuntimeError as e:
        err = e
    finally:
        setattr(module, name, fn)
    return fn, got, err


def _t(x):
    import torch

    return torch.as_tensor(np.asarray(x))


def port_state(state):
    from sfm_danpipeline_torch import interop

    return interop.state_from_numpy({f: np.asarray(getattr(state, f)) for f in STATE_FIELDS})


def port_key(key):
    import jax

    from sfm_danpipeline_torch import interop

    return interop.key_from_numpy(jax.random.key_data(key))


def step_args(a, config):
    """The reference's `_register_adjust_step` arguments `a` as keyword
    arguments of the port's `register_adjust_step` under `config`."""
    key, state, view, dv, ft_a, ft_b, vt_loose, vt_strict, xy, colors, pp, K, dist, max_dim = a[:14]
    return dict(
        key=port_key(key), state=port_state(state), new_view=int(view),
        done_views=[int(v) for v in np.asarray(dv) if v >= 0],
        tables=(_t(ft_a), _t(ft_b), _t(vt_strict), _t(vt_loose)), keypoints_xy=_t(xy),
        colors=_t(colors), pp=_t(pp), K=_t(K), dist=_t(dist), image_max_dim=float(max_dim),
        config=config, fix_cam=_t(a[15]), local_view=None if int(a[-1]) < 0 else int(a[-1]),
    )


def merge_args(a, config):
    """The reference's `_merge_attempt_step` arguments `a` as keyword
    arguments of the port's `merge_attempt_step` under `config`."""
    key, state_a, state_b, b_mask, dv_a, ft_a, ft_b, vt_strict, xy, colors, pp, K, dist, fix = a[:14]
    return dict(
        key=port_key(key), state_a=port_state(state_a), state_b=port_state(state_b),
        b_views=[int(v) for v in np.nonzero(np.asarray(b_mask))[0]],
        a_views=[int(v) for v in np.asarray(dv_a) if v >= 0],
        tables=(_t(ft_a), _t(ft_b), _t(vt_strict)), keypoints_xy=_t(xy), colors=_t(colors),
        pp=_t(pp), K=_t(K), dist=_t(dist), fix_cam=_t(fix), config=config,
    )


def merge_stats(stats):
    """The reference's merge stats[7] as the port's stats dict."""
    acc, sim_ok, n_inl, med1, med2, n_cross, scale = (int(x) for x in np.asarray(stats))

    def px(m):  # the reference caps a median at 1e6 px, the port's is inf
        return float("inf") if m >= 10**9 else m / 1000.0

    return dict(
        accepted=bool(acc), sim_ok=bool(sim_ok), n_sim_inliers=n_inl, med_gate1_px=px(med1),
        med_gate2_px=px(med2), n_cross_tracks=n_cross, scale=scale / 1000.0,
    )
