"""The port's command line: the ``main.cpp`` + roslaunch replacement
(port of ``hector/cli.py``).

    python -m hector_torch run --gait walking --vx 0.5 --seconds 3
    python -m hector_torch run --world stairs --vx 0.4
    python -m hector_torch batch --batch 4096 --seconds 2 --log out.jsonl
    python -m hector_torch teleop             # interactive wasd/jl teleop
    python -m hector_torch view --vx 0.5      # live ANSI sim view
    python -m hector_torch replay traj.csv    # offline trajectory (TO state)
    python -m hector_torch bench              # headline solves/s (bench.py)
    python -m hector_torch --device cpu run   # on the CPU, asked for

Every command runs on the card (``--device cuda``, the default) and fails
when there is none: the CPU runs only when ``--device cpu`` asks for it.
Commands come from flags, a scenario seed or the interactive teleop
(io/keyboard.py); results go to stdout, JSONL and PNG.  ``main`` returns
what the command printed as JSON (a dict), for callers in the same
process.
"""

from __future__ import annotations

import argparse
import json

from . import resolve_device


def _setup_scenario(args, device, n_periods=None, seconds=None):
    """Shared one-lane scenario setup for run/view/export-html: world
    config, command, plant state, controller carry and the rollout (srb or
    whole-body, per --plant/--estimator).  Pass either n_periods or seconds
    (converted with the world-applied config's period).  The command
    carries the world's terrain only for the walking gait (standing pins
    flat ground), so consumers read the terrain from the command."""
    from . import runtime as RT
    from . import worlds
    from .plant import srb
    from .config import DEFAULT_CONFIG

    CFG, terrain = worlds.apply(args.world, DEFAULT_CONFIG)
    if n_periods is None:
        n_periods = int(seconds / (CFG.mpc.dt * CFG.mpc.mpc_cadence))
    cmd = (RT.standing_command(1, device=device) if args.gait == "standing"
           else RT.walking_command(1, vx=args.vx, vy=args.vy,
                                   yaw_rate=args.yaw_rate,
                                   step_height=terrain.step_height,
                                   step_length=terrain.step_length,
                                   device=device))
    if args.plant == "whole-body":
        from .plant import whole_body as WB
        plant = WB.init_whole_body_state(0.545, 1, device=device)
        roll = RT.make_rollout_whole_body(n_periods, CFG,
                                          estimator=args.estimator)
    else:
        plant = srb.init_plant_state(1, CFG, device=device)
        roll = RT.make_rollout(n_periods, CFG, estimator=args.estimator)
    return CFG, cmd, plant, roll.init(plant), roll


def cmd_run(args, device):
    from .io.metrics import summarize_rollout

    CFG, cmd, plant, carry, roll = _setup_scenario(
        args, device, seconds=args.seconds)
    carry, plant, diags = roll(carry, plant, cmd)
    summary = summarize_rollout(diags)
    summary["x_traveled"] = float(plant.position[0, 0])
    print(json.dumps(summary, indent=2))
    if args.plot:
        from .io.viz import plot_tracking
        plot_tracking({k: v[0] for k, v in diags.items()}, v_des=args.vx,
                      path=args.plot)
        print(f"wrote {args.plot}")
    return summary


def cmd_batch(args, device):
    from . import parallel as PAR
    from . import prng
    from .io import scenarios as SC
    from .config import DEFAULT_CONFIG as CFG
    from .io.metrics import MetricsLogger

    mesh = PAR.data_mesh(device=device)
    key = prng.PRNGKey(args.seed, mesh[0])
    carry, plant, _ = PAR.make_batch(args.batch, cfg=CFG, mesh=mesh)
    cmd = PAR.shard_batch(SC.random_commands(key, args.batch), mesh)
    n_periods = int(args.seconds / (CFG.mpc.dt * CFG.mpc.mpc_cadence))
    roll = PAR.make_sharded_rollout(n_periods, mesh, CFG)
    carry, plant, metrics = roll(carry, plant, cmd)
    # the key order the JAX CLI prints (its metrics come back sorted)
    metrics = {k: metrics[k] for k in sorted(metrics)}
    logger = MetricsLogger(args.log)
    rec = logger.log(0, metrics, batch=args.batch, devices=len(mesh))
    logger.close()
    print(json.dumps(rec, indent=2))
    if args.checkpoint:
        from .io import checkpoint as CKPT
        CKPT.save(args.checkpoint, n_periods, PAR.gather(carry),
                  PAR.gather(plant), PAR.gather(cmd))
        print(f"checkpointed to {args.checkpoint}")
    return rec


def cmd_bench(args, device):
    """The headline benchmark (hector_torch/bench.py).  --batch is ignored,
    as the JAX CLI ignores it: bench.BATCH lanes always run."""
    from . import bench
    return bench.main(device)


def cmd_teleop(args, device):
    """Interactive closed-loop teleop (the KeyBoard/CmdPanel experience):
    wasd/jl steer, space stops, q quits.  One MPC period (5 ms sim time)
    per loop iteration; --live renders the ANSI side-view each period,
    otherwise a one-line status ticker."""
    from . import runtime as RT
    from . import math as hm
    from . import worlds
    from .plant import srb
    from .config import DEFAULT_CONFIG
    from .io import keyboard as KB
    from .io import live

    CFG, terrain = worlds.apply(args.world, DEFAULT_CONFIG)
    plant = srb.init_plant_state(1, CFG, device=device)
    carry = RT.init_controller_carry(plant, CFG)
    roll = RT.make_rollout(1, CFG)
    value = KB.UserValue()
    print("teleop: w/s=vx  j/l=vy  a/d=yaw  space=stop  q=quit")
    with KB.RawTerminal() as term:
        t = 0.0
        while True:
            key = term.poll_key(timeout=0.0)
            if key in ("q", "\x03"):
                break
            if key:
                value = KB.update_value(value, key)
            vx, vy, yaw_rate = KB.value_to_command(value)
            cmd = RT.walking_command(
                1, vx=vx, vy=vy, yaw_rate=yaw_rate,
                step_height=terrain.step_height,
                step_length=terrain.step_length, device=device)
            carry, plant, diags = roll(carry, plant, cmd)
            t += CFG.mpc.dt * CFG.mpc.mpc_cadence
            if args.live:
                hips_w, feet_w, contact = live.frame_geometry(plant, CFG)
                fz = diags["wrench"][0, 0, :, 2].double().cpu().numpy()
                frame = live.render_frame(
                    plant.position[0].cpu().numpy(),
                    hm.quat_to_rpy(plant.quat[0]).cpu().numpy(),
                    hips_w, feet_w, contact, fz, t,
                    f"cmd vx={vx:+5.2f} vy={vy:+5.2f} wz={yaw_rate:+5.2f}"
                    f"  (wasd/jl steer, q quits)",
                    step_height=float(terrain.step_height),
                    step_length=float(terrain.step_length))
                print(live.ANSI_HOME + frame, flush=True)
            else:
                p = plant.position[0]
                print(f"\rt={t:7.2f}s  x={float(p[0]):+6.2f} "
                      f"y={float(p[1]):+6.2f} z={float(p[2]):5.2f}  "
                      f"cmd vx={vx:+5.2f} vy={vy:+5.2f} "
                      f"wz={yaw_rate:+5.2f}  ", end="", flush=True)
    print()


def cmd_view(args, device):
    """Live ANSI side-view of a running sim (the Gazebo-GUI/rviz analog,
    io/live.py): one MPC period per frame, paced near real time;
    --plant whole-body watches the articulated physics."""
    import time as _time
    from . import runtime as RT
    from . import math as hm
    from .io import live

    CFG, cmd, plant, carry, roll = _setup_scenario(args, device,
                                                   n_periods=1)
    period = CFG.mpc.dt * CFG.mpc.mpc_cadence
    n_frames = max(1, int(args.seconds / period))
    cmd_text = (f"cmd vx={args.vx:+.2f} vy={args.vy:+.2f} "
                f"wz={args.yaw_rate:+.2f}  world={args.world}")
    t = 0.0
    for _ in range(n_frames):
        t0 = _time.perf_counter()
        carry, plant, diags = roll(carry, plant, cmd)
        t += period
        obs = (RT.whole_body_observation(plant)
               if args.plant == "whole-body" else plant)
        hips_w, feet_w, contact = live.frame_geometry(obs, CFG)
        fz = diags["wrench"][0, 0, :, 2].double().cpu().numpy()
        frame = live.render_frame(
            plant.position[0].cpu().numpy(),
            hm.quat_to_rpy(plant.quat[0]).cpu().numpy(),
            hips_w, feet_w, contact, fz, t, cmd_text,
            # draw the terrain the plant simulated (the command's):
            # standing pins flat ground whatever the world preset
            step_height=float(cmd.terrain_step_height[0]),
            step_length=float(cmd.terrain_step_length[0]))
        print(live.ANSI_HOME + frame, flush=True)
        if args.speed > 0:
            _time.sleep(max(0.0, period / args.speed
                            - (_time.perf_counter() - t0)))
    print()


def cmd_export_html(args, device):
    """Export an interactive self-contained 3D HTML viewer of a scenario
    rollout (the rviz/Gazebo-GUI analog, io/html_viz.py): trunk box,
    articulated leg chains, toe boxes, one frame per MPC period."""
    import numpy as np
    from .io import html_viz

    CFG, cmd, plant, carry, roll = _setup_scenario(args, device,
                                                   n_periods=1)
    period = CFG.mpc.dt * CFG.mpc.mpc_cadence
    n_frames = max(1, int(args.seconds / period))
    if args.plant == "whole-body":
        from .plant import whole_body as _WB

        def get_contact(p):
            return p.sticking[0, :_WB.N_TOE].reshape(2, -1).any(-1) \
                .cpu().numpy()
    else:
        def get_contact(p):
            return p.contact[0].cpu().numpy()
    frames, contacts, forces = [], [], []
    for _ in range(n_frames):
        carry, plant, diags = roll(carry, plant, cmd)
        frames.append(html_viz.skeleton_points(
            plant.position[0], plant.quat[0], plant.q[0], CFG))
        contacts.append(get_contact(plant))
        # per-leg world GRF from the telemetry channel (wrench (1, 1, 2, 6))
        forces.append(diags["wrench"][0, 0, :, 0:3].double().cpu().numpy())
    # the drawn grid's terrain comes from the command (what the plant
    # simulated), not the world preset: standing pins flat ground
    html_viz.export_html(
        np.stack(frames), np.stack(contacts), args.out, period,
        terrain=(float(cmd.terrain_step_height[0]),
                 float(cmd.terrain_step_length[0])),
        forces=np.stack(forces),
        title=f"hector {args.plant} vx={args.vx} world={args.world}")
    rep = {"wrote": args.out, "frames": n_frames,
           "seconds": n_frames * period}
    print(json.dumps(rep))
    return rep


def cmd_replay(args, device):
    """Offline-trajectory playback (the FSMState_TO capability): load a CSV
    trajectory table; --closed-loop drives the controller and the plant
    from it and reports tracking errors, otherwise summarize the table."""
    from .io.trajectory import TrajectoryTable, closed_loop_replay

    table = TrajectoryTable.from_csv(args.csv, device)
    if args.closed_loop:
        report, diags = closed_loop_replay(table, seconds=args.seconds)
        print(json.dumps(report, indent=2))
        if args.plot:
            from .io.viz import plot_tracking
            plot_tracking(diags, path=args.plot)
            print(f"wrote {args.plot}")
        return report
    times = table.times.cpu().numpy()
    states = table.state_at(table.times).cpu().numpy()
    rep = {
        "rows": int(times.shape[0]),
        "t_span": [float(times[0]), float(times[-1])],
        "state_dim": int(states.shape[1]),
        "first_state": [round(float(v), 6) for v in states[0]],
        "final_state": [round(float(v), 6) for v in states[-1]],
    }
    print(json.dumps(rep, indent=2))
    return rep


def _scenario_flags(parser, seconds, plant=True):
    parser.add_argument("--gait", choices=["standing", "walking"],
                        default="walking")
    parser.add_argument("--vx", type=float, default=0.5)
    parser.add_argument("--vy", type=float, default=0.0)
    parser.add_argument("--yaw-rate", type=float, default=0.0)
    parser.add_argument("--seconds", type=float, default=seconds)
    parser.add_argument("--world", default="normal",
                        help="world preset (hector_torch/worlds.py): "
                             "normal, earth, space, stairs, ...")
    parser.add_argument("--plant", choices=["srb", "whole-body"],
                        default="srb",
                        help="tier-1 SRB plant or tier-2 articulated physics")
    parser.add_argument("--estimator", choices=["cheater", "filtered", "kf"],
                        default="cheater",
                        help="estimator driving the controller "
                             "(hector_torch/estimation.py)")


def main(argv=None):
    p = argparse.ArgumentParser(prog="hector_torch")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; there is no "
                        "fallback: pass --device cpu to run on the CPU)")
    sub = p.add_subparsers(dest="command", required=True)

    r = sub.add_parser("run", help="single-scenario closed-loop sim")
    _scenario_flags(r, 3.0)
    r.add_argument("--plot", default=None, help="write tracking PNG")
    r.set_defaults(fn=cmd_run)

    t = sub.add_parser("teleop", help="interactive keyboard teleop")
    t.add_argument("--world", default="normal")
    t.add_argument("--live", action="store_true",
                   help="render the live ANSI side-view each period")
    t.set_defaults(fn=cmd_teleop)

    v = sub.add_parser("view", help="live ANSI view of a running sim")
    _scenario_flags(v, 5.0)
    v.add_argument("--speed", type=float, default=1.0,
                   help="playback speed multiple of real time; 0 = "
                        "as fast as the rollout runs")
    v.set_defaults(fn=cmd_view)

    x = sub.add_parser("export-html",
                       help="write a self-contained 3D HTML viewer")
    x.add_argument("out", help="output .html path")
    _scenario_flags(x, 3.0)
    x.set_defaults(fn=cmd_export_html)

    rp = sub.add_parser("replay", help="offline trajectory playback (TO)")
    rp.add_argument("csv", help="trajectory CSV (time + 12-dim state + ...)")
    rp.add_argument("--closed-loop", action="store_true",
                    help="drive the controller+plant from the table and "
                         "report tracking errors")
    rp.add_argument("--seconds", type=float, default=None,
                    help="override replay duration")
    rp.add_argument("--plot", default=None, help="write tracking PNG")
    rp.set_defaults(fn=cmd_replay)

    b = sub.add_parser("batch", help="batched randomized scenarios")
    b.add_argument("--batch", type=int, default=1024)
    b.add_argument("--seconds", type=float, default=1.0)
    b.add_argument("--seed", type=int, default=0)
    b.add_argument("--log", default=None, help="JSONL metrics path")
    b.add_argument("--checkpoint", default=None,
                   help="checkpoint directory (io/checkpoint.py)")
    b.set_defaults(fn=cmd_batch)

    be = sub.add_parser("bench", help="headline solves/s benchmark")
    be.add_argument("--batch", type=int, default=4096,
                    help="ignored, as in the JAX CLI: the benchmark always "
                         "runs 32,768 lanes")
    be.set_defaults(fn=cmd_bench)

    args = p.parse_args(argv)
    try:
        device = resolve_device(args.device)
    except RuntimeError as err:
        p.error(str(err))
    return args.fn(args, device)
