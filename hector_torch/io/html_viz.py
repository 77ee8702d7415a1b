"""Self-contained interactive 3D viewer export (the rviz / Gazebo-GUI
analog, one HTML file, zero dependencies; port of ``hector/io/html_viz.py``).

The reference's 3D visualization is rviz + the Gazebo client
(hector_description/launch/hector_rviz.launch, draw-force plugin
unitree_gazebo/plugin/draw_force_plugin.cc).  The batched engine's analog:
run a scenario rollout, capture the robot's full skeleton (trunk box,
per-leg 5-joint chains from the articulated FK, toe-box contact corners)
each MPC period, and write ONE self-contained HTML file -- inline data +
hand-rolled canvas renderer (orthographic isometric projection, mouse-drag
orbit, play/scrub/speed controls, stairs-aware ground grid, contact
highlighting).  Works from any browser with no server, no egress, no JS
dependencies; `python -m hector_torch export-html out.html`.

Both plant tiers export through the same path: the skeleton is computed
from (position, quat, q), which both PlantState and WholeBodyState carry;
the port computes it with ``plant.rnea.fk_chain`` and
``contact_points_and_jac`` on the data's device.  The HTML is the JAX
module's, byte for byte.
"""

from __future__ import annotations

import html as _html
import json

import numpy as np

# static skeleton topology over the 26 exported points:
#   0-7    trunk box corners (x: -/+, y: -/+, z: -/+ order)
#   8-12   left leg joint-chain origins (hip_yaw..toe)
#   13-16  left toe box corners
#   17-21  right leg joint-chain origins
#   22-25  right toe box corners
_TRUNK_EDGES = [(0, 1), (2, 3), (4, 5), (6, 7), (0, 2), (1, 3), (4, 6),
                (5, 7), (0, 4), (1, 5), (2, 6), (3, 7)]
_LEG_EDGES = [(0, 1), (1, 2), (2, 3), (3, 4)]
_TOE_EDGES = [(0, 1), (1, 3), (3, 2), (2, 0)]

TRUNK_HALF = (0.08, 0.097, 0.125)   # display half-extents (const.xacro trunk
                                    # box scale; visual only)


def segments():
    segs = list(_TRUNK_EDGES)
    for base in (8, 17):
        segs += [(base + a, base + b) for a, b in _LEG_EDGES]
    for base in (13, 22):
        segs += [(base + a, base + b) for a, b in _TOE_EDGES]
    # ankle to toe box front corners
    segs += [(12, 13), (12, 14), (21, 22), (21, 23)]
    return segs


def skeleton_points(position, quat, q, cfg=None) -> np.ndarray:
    """(26, 3) world skeleton points for one frame: position (3,), quat
    (4,), q (2, 5), tensors (on any device) or arrays (cfg unused; kept for
    call-site symmetry with the live viewer)."""
    import torch
    from .. import math as hm
    from ..plant import rnea

    pos = torch.as_tensor(position)[None]
    quat = torch.as_tensor(quat).to(pos)[None]
    qj = torch.as_tensor(q).to(pos)[None]
    hx, hy, hz = TRUNK_HALF
    corners = torch.tensor([[sx * hx, sy * hy, sz * hz]
                            for sx in (-1, 1) for sy in (-1, 1)
                            for sz in (-1, 1)], dtype=pos.dtype).to(pos)
    rot = hm.quat_to_rot(quat)
    trunk = pos + corners @ rot[0].T
    _, orgs, _ = rnea.fk_chain(pos, rot, qj)
    pts, _, _ = rnea.contact_points_and_jac(
        pos, rot, qj, torch.zeros((1, 16), dtype=pos.dtype).to(pos))
    toes = pts[0].reshape(2, 4, 3)
    out = torch.cat([trunk, orgs[0, 0], toes[0], orgs[0, 1], toes[1]], dim=0)
    return out.detach().cpu().numpy()


def export_html(frames, contacts, path, dt_frame, terrain=(0.0, 1.0),
                forces=None, title="hector 3D view"):
    """frames: (T, 26, 3) float array; contacts: (T, 2) bools; forces:
    optional (T, 2, 3) per-leg world GRF [N] rendered as arrows from each
    toe-box centroid (the draw_force_plugin analog,
    unitree_gazebo/plugin/draw_force_plugin.cc -- its /20 world-unit
    scale makes 100 N a 5 m line, so the viewer uses /200 for
    legibility)."""
    frames = np.asarray(frames, float)
    data = dict(
        dt=float(dt_frame),
        segs=segments(),
        terrain=[float(terrain[0]), float(terrain[1])],
        contact=np.asarray(contacts, int).tolist(),
        pts=[[[round(float(v), 3) for v in p] for p in f] for f in frames])
    if forces is not None:
        data["force"] = [[[round(float(v), 1) for v in leg] for leg in f]
                         for f in np.asarray(forces, float)]
    html = _TEMPLATE.replace("__TITLE__", _html.escape(title)).replace(
        "__DATA__", json.dumps(data, separators=(",", ":")))
    with open(path, "w") as f:
        f.write(html)
    return path


_TEMPLATE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>__TITLE__</title><style>
body{margin:0;background:#10141a;color:#dce3ec;font:13px monospace}
#bar{padding:6px 10px;display:flex;gap:12px;align-items:center}
canvas{display:block}button{background:#263041;color:#dce3ec;border:0;
padding:4px 10px;font:inherit;cursor:pointer}input[type=range]{width:240px}
</style></head><body>
<div id="bar"><button id="play">pause</button>
<input id="scrub" type="range" min="0" value="0" step="1">
<span id="tlab"></span>
<label>speed <select id="spd"><option>0.25</option><option>0.5</option>
<option selected>1</option><option>2</option></select>x</label>
<span style="opacity:.6">drag to orbit &middot; wheel to zoom</span></div>
<canvas id="cv"></canvas><script>
const D=__DATA__;
const cv=document.getElementById('cv'),cx=cv.getContext('2d');
let W,Hh;function rs(){W=cv.width=innerWidth;Hh=cv.height=innerHeight-40;}
rs();addEventListener('resize',rs);
let yaw=-0.7,pitch=0.42,zoom=420,fi=0,playing=true,speed=1,acc=0;
const scrub=document.getElementById('scrub');scrub.max=D.pts.length-1;
document.getElementById('play').onclick=e=>{playing=!playing;
 e.target.textContent=playing?'pause':'play';};
document.getElementById('spd').onchange=e=>speed=+e.target.value;
scrub.oninput=e=>{fi=+e.target.value;playing=false;
 document.getElementById('play').textContent='play';};
let drag=null;cv.onmousedown=e=>drag=[e.clientX,e.clientY];
onmouseup=()=>drag=null;
onmousemove=e=>{if(drag){yaw+=(e.clientX-drag[0])*0.008;
 pitch+=(e.clientY-drag[1])*0.008;
 pitch=Math.max(0.05,Math.min(1.4,pitch));drag=[e.clientX,e.clientY];}};
cv.onwheel=e=>{zoom*=Math.exp(-e.deltaY*0.001);e.preventDefault();};
function proj(p,c){const x=p[0]-c[0],y=p[1]-c[1],z=p[2];
 const cy=Math.cos(yaw),sy=Math.sin(yaw);
 const x1=x*cy-y*sy,y1=x*sy+y*cy;
 const cp=Math.cos(pitch),sp=Math.sin(pitch);
 const y2=y1*cp-z*sp;
 return [W/2+x1*zoom,Hh*0.62+y2*zoom*0.9];}
function ground(c){const [sh,sl]=D.terrain;cx.strokeStyle='#263041';
 cx.lineWidth=1;
 for(let gx=-8;gx<=24;gx++){for(let gy=-6;gy<6;gy++){
  const x0=c[0]+gx*0.25,y0=gy*0.25;
  const z=sh?sh*Math.floor(x0/Math.max(sl,1e-3)):0;
  const q=[[x0,y0,z],[x0+0.25,y0,z],[x0+0.25,y0+0.25,z],[x0,y0+0.25,z]]
   .map(p=>proj(p,c));
  cx.beginPath();cx.moveTo(q[0][0],q[0][1]);
  for(let k=1;k<4;k++)cx.lineTo(q[k][0],q[k][1]);
  cx.closePath();cx.stroke();}}}
function draw(){const f=D.pts[fi],con=D.contact[fi];
 let mx=0;for(const p of f)mx+=p[0];mx/=f.length;
 const c=[mx,0];cx.fillStyle='#10141a';cx.fillRect(0,0,W,Hh);
 ground(c);
 const P=f.map(p=>proj(p,c));
 cx.lineWidth=2;
 D.segs.forEach(([a,b],i)=>{
  let col='#7fb3ff';
  if(a>=8&&a<17)col=con[0]?'#58d68d':'#e8c468';
  if(a>=17)col=con[1]?'#58d68d':'#e8a0a0';
  if(a<8)col='#9aa7ff';
  cx.strokeStyle=col;cx.beginPath();
  cx.moveTo(P[a][0],P[a][1]);cx.lineTo(P[b][0],P[b][1]);cx.stroke();});
 if(D.force){const fr=D.force[fi];cx.strokeStyle='#ff6b6b';
  [[13,17],[22,26]].forEach(([a,b],leg)=>{
   let gx=0,gy=0,gz=0;
   for(let k=a;k<b;k++){gx+=f[k][0];gy+=f[k][1];gz+=f[k][2];}
   const cpt=[gx/4,gy/4,gz/4];
   const tip=[cpt[0]+fr[leg][0]/200,cpt[1]+fr[leg][1]/200,
              cpt[2]+fr[leg][2]/200];
   const p0=proj(cpt,c),p1=proj(tip,c);
   cx.beginPath();cx.moveTo(p0[0],p0[1]);cx.lineTo(p1[0],p1[1]);
   cx.stroke();});}
 document.getElementById('tlab').textContent=
  't='+(fi*D.dt).toFixed(2)+'s  frame '+fi+'/'+(D.pts.length-1);
 scrub.value=fi;}
let last=performance.now();
function loop(now){const el=(now-last)/1000;last=now;
 if(playing){acc+=el*speed;while(acc>=D.dt){acc-=D.dt;
  fi=(fi+1)%D.pts.length;}}
 draw();requestAnimationFrame(loop);}
requestAnimationFrame(loop);
</script></body></html>
"""
