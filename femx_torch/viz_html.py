"""Self-contained interactive HTML/WebGL result viewer (port of
femx/viz_html.py).

The reference opens interactive PyVista/VTK windows for solid results
(ReactionSolver.py:234-294). A desktop window is of no use on a headless
GPU host, so femx, and this port, export a single standalone HTML file
(raw WebGL, no external libraries, no network) with:

  * the deformed surface mesh, per-vertex colored by |u| or von Mises
  * an interactive warp-factor slider (warping happens in the vertex
    shader: position and displacement are separate attributes)
  * orbit (drag) + zoom (wheel) camera
  * fixed-node (blue) / loaded-node (red) markers with a reaction/force
    legend

Everything (geometry, fields, shaders) is embedded in the file; it opens
from disk in any browser. Pure numpy and json: it needs no matplotlib.
"""

from __future__ import annotations

import json
import os

import numpy as np


def _jet(t: np.ndarray) -> np.ndarray:
    """Jet colormap (matches the reference's PyVista 'jet'), (N,) -> (N,3)."""
    t = np.clip(t, 0.0, 1.0)
    r = np.clip(1.5 - np.abs(4 * t - 3.0), 0, 1)
    g = np.clip(1.5 - np.abs(4 * t - 2.0), 0, 1)
    b = np.clip(1.5 - np.abs(4 * t - 1.0), 0, 1)
    return np.stack([r, g, b], axis=1)


def export_solid_html(analysis, filename: str = "fem_result.html",
                      factor: float = 1.0) -> str:
    """Write a standalone interactive viewer for a solved solid analysis."""
    if analysis.u is None:
        raise RuntimeError("Run the analysis first.")
    from femx_torch.viz import _surface_triangles

    pts = np.asarray(analysis.points, dtype=np.float64)
    disp = np.asarray(analysis.u, dtype=np.float64).reshape(-1, 3)
    tris = np.asarray(_surface_triangles(analysis.tetra10_conn))

    # compact to surface-referenced vertices only
    used = np.unique(tris.reshape(-1))
    remap = np.full(len(pts), -1, dtype=np.int64)
    remap[used] = np.arange(len(used))
    tris_c = remap[tris]
    p = pts[used]
    u = disp[used]

    fields = {"|u| (m)": np.linalg.norm(u, axis=1)}
    vm = getattr(analysis, "nodal_von_mises", None)
    if vm is None:
        _, vm = analysis.compute_stresses()
    fields["von Mises (Pa)"] = np.asarray(vm, dtype=np.float64)[used]

    markers = []
    for i, info in enumerate(getattr(analysis, "fixed_nodes_info", [])):
        n = info["node_idx"]
        r = (analysis.reaction_forces[3 * n : 3 * n + 3]
             if analysis.reaction_forces is not None else np.zeros(3))
        markers.append({
            "pos": [float(v) for v in pts[n]],
            "disp": [float(v) for v in disp[n]],
            "color": [0.2, 0.4, 1.0],
            "label": (f"Fix {i + 1}: Rx={r[0]:.3e} Ry={r[1]:.3e} "
                      f"Rz={r[2]:.3e} N"),
        })
    for i, info in enumerate(getattr(analysis, "applied_forces_info", [])):
        n = info["node_idx"]
        fv = info["force_vec"]
        markers.append({
            "pos": [float(v) for v in pts[n]],
            "disp": [float(v) for v in disp[n]],
            "color": [1.0, 0.25, 0.2],
            "label": (f"Force {i + 1}: Fx={fv[0]:.3e} Fy={fv[1]:.3e} "
                      f"Fz={fv[2]:.3e} N"),
        })

    lo, hi = p.min(axis=0), p.max(axis=0)
    center = 0.5 * (lo + hi)
    radius = float(np.linalg.norm(hi - lo)) / 2.0 or 1.0

    data = {
        "positions": np.round(p, 9).reshape(-1).tolist(),
        "disps": u.reshape(-1).tolist(),
        "indices": tris_c.reshape(-1).tolist(),
        "fields": {k: v.tolist() for k, v in fields.items()},
        "markers": markers,
        "center": center.tolist(),
        "radius": radius,
        "factor0": float(factor),
        "title": "femx solid analysis",
    }

    html = _TEMPLATE.replace("__DATA__", json.dumps(data))
    with open(filename, "w") as f:
        f.write(html)
    return os.path.abspath(filename)


def export_mesh_html(mesh, filename: str = "mesh_preview.html") -> str:
    """Write a standalone PRE-SOLVE mesh inspector (no analysis needed).

    The reference pops the gmsh FLTK viewer after meshing so the user can
    check the mesh before solving (gmsh_creation.py:95-97); this is the
    headless equivalent: surface colored by volume physical group, black
    wireframe edges, one colored marker per 0-D/vertex physical-group
    node, and a legend of all physical groups with entity counts.
    Works for solid (tetra10) and frame (line) meshes."""
    pts = np.asarray(mesh.points, dtype=np.float64)
    cells = mesh.cells
    cell_phys = getattr(mesh, "cell_physical", {}) or {}
    names_of_tag = {}
    for name, (tag, _dim) in (getattr(mesh, "field_data", {}) or {}).items():
        names_of_tag[int(tag)] = name

    palette = np.array([
        [0.55, 0.63, 0.80], [0.85, 0.65, 0.40], [0.55, 0.78, 0.55],
        [0.80, 0.55, 0.75], [0.70, 0.70, 0.45], [0.45, 0.75, 0.78],
    ])
    marker_palette = np.array([
        [0.2, 0.4, 1.0], [1.0, 0.25, 0.2], [0.15, 0.7, 0.25],
        [0.85, 0.6, 0.1], [0.7, 0.2, 0.8],
    ])

    tris_c = np.zeros((0, 3), dtype=np.int64)
    lines_c = np.zeros((0, 2), dtype=np.int64)
    legend = []
    if "tetra10" in cells:
        from femx_torch.viz import _surface_triangles

        conn = np.asarray(cells["tetra10"])
        tris = np.asarray(_surface_triangles(conn))
        used = np.unique(np.r_[tris.reshape(-1)])
        vcol = np.full((len(pts), 3), 0.62)
        phys = np.asarray(cell_phys.get("tetra10",
                                        np.zeros(len(conn), np.int32)))
        for i, tag in enumerate(np.unique(phys)):
            nodes = np.unique(conn[phys == tag][:, :4])
            vcol[nodes] = palette[i % len(palette)]
            legend.append(f"{names_of_tag.get(int(tag), f'tag {tag}')}: "
                          f"{int((phys == tag).sum())} tetra10")
        tris_c = tris
        # unique wireframe edges of the surface corner triangles
        e = np.r_[tris[:, [0, 1]], tris[:, [1, 2]], tris[:, [0, 2]]]
        lines_c = np.unique(np.sort(e, axis=1), axis=0)
    elif "line" in cells:
        conn = np.asarray(cells["line"])
        used = np.unique(conn.reshape(-1))
        vcol = np.full((len(pts), 3), 0.2)
        phys = np.asarray(cell_phys.get("line",
                                        np.zeros(len(conn), np.int32)))
        for i, tag in enumerate(np.unique(phys)):
            nodes = np.unique(conn[phys == tag])
            vcol[nodes] = palette[i % len(palette)]
            legend.append(f"{names_of_tag.get(int(tag), f'tag {tag}')}: "
                          f"{int((phys == tag).sum())} line")
        lines_c = conn[:, :2]
    else:
        raise ValueError("mesh has neither tetra10 nor line cells")

    from femx_torch.mesh.core import nodes_in_physical_group

    markers = []
    mi = 0
    for name, (tag, dim) in sorted((getattr(mesh, "field_data", {}) or {})
                                   .items(), key=lambda kv: kv[1][0]):
        if dim != 0:
            continue
        nodes = nodes_in_physical_group(mesh, name)
        color = marker_palette[mi % len(marker_palette)]
        mi += 1
        legend.append(f"{name}: {len(nodes)} node(s)")
        for n in np.asarray(nodes)[:500]:
            p = pts[int(n)]
            markers.append({
                "pos": [float(v) for v in p],
                "disp": [0.0, 0.0, 0.0],
                "color": [float(c) for c in color],
                "label": (f"{name} @ ({p[0]:.4g}, {p[1]:.4g}, "
                          f"{p[2]:.4g})"),
            })

    # compact to referenced vertices
    refd = np.unique(np.r_[tris_c.reshape(-1), lines_c.reshape(-1), used])
    remap = np.full(len(pts), -1, dtype=np.int64)
    remap[refd] = np.arange(len(refd))
    p = pts[refd]
    lo, hi = p.min(axis=0), p.max(axis=0)
    center = 0.5 * (lo + hi)
    radius = float(np.linalg.norm(hi - lo)) / 2.0 or 1.0

    data = {
        "positions": np.round(p, 9).reshape(-1).tolist(),
        "disps": np.zeros_like(p).reshape(-1).tolist(),
        "indices": remap[tris_c].reshape(-1).tolist(),
        "lineIndices": remap[lines_c].reshape(-1).tolist(),
        "colors": np.round(vcol[refd], 4).reshape(-1).tolist(),
        "fields": {},
        "markers": markers,
        "legend": legend,
        "center": center.tolist(),
        "radius": radius,
        "factor0": 0.0,
        "title": (f"femx mesh preview — {len(pts)} nodes, "
                  + ", ".join(f"{len(np.asarray(c))} {k}"
                              for k, c in cells.items())),
    }
    html = _TEMPLATE.replace("__DATA__", json.dumps(data))
    with open(filename, "w") as f:
        f.write(html)
    return os.path.abspath(filename)


_TEMPLATE = r"""<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>femx result viewer</title>
<style>
 body{margin:0;background:#111;color:#ddd;font:13px sans-serif;overflow:hidden}
 #hud{position:absolute;top:8px;left:8px;background:#000a;padding:8px 12px;
      border-radius:6px;max-width:420px}
 #legend{margin-top:6px;white-space:pre;font-family:monospace;font-size:11px}
 #bar{position:absolute;right:14px;top:8%;height:84%;width:18px;
      border:1px solid #666}
 #barlab{position:absolute;right:40px;top:8%;height:84%;display:flex;
      flex-direction:column;justify-content:space-between;font-size:11px}
 canvas{display:block}
 select,input{vertical-align:middle}
</style></head><body>
<canvas id="gl"></canvas>
<div id="hud">
 <b id="title"></b><br>
 field <select id="field"></select>
 warp <input id="warp" type="range" min="0" max="4" step="0.01">
 <span id="warpv"></span>x
 <div id="legend"></div>
</div>
<div id="bar"></div><div id="barlab"><span id="vmax"></span><span id="vmid">
</span><span id="vmin"></span></div>
<script>
const D = __DATA__;
const canvas = document.getElementById('gl');
const gl = canvas.getContext('webgl');
function jet(t){t=Math.min(1,Math.max(0,t));
 return [Math.min(1,Math.max(0,1.5-Math.abs(4*t-3))),
         Math.min(1,Math.max(0,1.5-Math.abs(4*t-2))),
         Math.min(1,Math.max(0,1.5-Math.abs(4*t-1)))];}
const VS=`attribute vec3 aPos;attribute vec3 aDisp;attribute vec3 aCol;
uniform mat4 uMVP;uniform float uWarp;varying vec3 vCol;
void main(){gl_Position=uMVP*vec4(aPos+uWarp*aDisp,1.0);vCol=aCol;
gl_PointSize=9.0;}`;
const FS=`precision mediump float;varying vec3 vCol;
void main(){gl_FragColor=vec4(vCol,1.0);}`;
function mkProg(){const p=gl.createProgram();
 for(const [t,s] of [[gl.VERTEX_SHADER,VS],[gl.FRAGMENT_SHADER,FS]]){
  const sh=gl.createShader(t);gl.shaderSource(sh,s);gl.compileShader(sh);
  gl.attachShader(p,sh);}
 gl.linkProgram(p);return p;}
const prog=mkProg();gl.useProgram(prog);
const loc={pos:gl.getAttribLocation(prog,'aPos'),
 disp:gl.getAttribLocation(prog,'aDisp'),col:gl.getAttribLocation(prog,'aCol'),
 mvp:gl.getUniformLocation(prog,'uMVP'),warp:gl.getUniformLocation(prog,'uWarp')};
function buf(data,target){const b=gl.createBuffer();
 gl.bindBuffer(target||gl.ARRAY_BUFFER,b);
 gl.bufferData(target||gl.ARRAY_BUFFER,data,gl.STATIC_DRAW);return b;}
const posB=buf(new Float32Array(D.positions));
const dispB=buf(new Float32Array(D.disps));
const colB=gl.createBuffer();
const idxB=buf(new Uint32Array(D.indices),gl.ELEMENT_ARRAY_BUFFER);
gl.getExtension('OES_element_index_uint');
const nIdx=D.indices.length, nVert=D.positions.length/3;
const nLineIdx=(D.lineIndices||[]).length;
const lineIdxB=nLineIdx?buf(new Uint32Array(D.lineIndices),
 gl.ELEMENT_ARRAY_BUFFER):null;
// markers: separate small buffers
const mPos=[],mDisp=[],mCol=[];
for(const m of D.markers){mPos.push(...m.pos);mDisp.push(...m.disp);
 mCol.push(...m.color);}
const mPosB=buf(new Float32Array(mPos)),mDispB=buf(new Float32Array(mDisp)),
 mColB=buf(new Float32Array(mCol));
// field coloring
const sel=document.getElementById('field');
for(const k of Object.keys(D.fields)){const o=document.createElement('option');
 o.textContent=k;sel.appendChild(o);}
function setField(name){const f=D.fields[name];
 let lo=Math.min(...f),hi=Math.max(...f);if(hi<=lo)hi=lo+1;
 const cols=new Float32Array(nVert*3);
 for(let i=0;i<nVert;i++){const c=jet((f[i]-lo)/(hi-lo));
  cols[3*i]=c[0];cols[3*i+1]=c[1];cols[3*i+2]=c[2];}
 gl.bindBuffer(gl.ARRAY_BUFFER,colB);
 gl.bufferData(gl.ARRAY_BUFFER,cols,gl.STATIC_DRAW);
 document.getElementById('vmax').textContent=hi.toExponential(3);
 document.getElementById('vmid').textContent=((lo+hi)/2).toExponential(3);
 document.getElementById('vmin').textContent=lo.toExponential(3);
 const bar=document.getElementById('bar');let g='linear-gradient(to top';
 for(let i=0;i<=10;i++){const c=jet(i/10);
  g+=`,rgb(${255*c[0]|0},${255*c[1]|0},${255*c[2]|0})`;}
 bar.style.background=g+')';}
sel.onchange=()=>{setField(sel.value);draw();};
if(Object.keys(D.fields).length){setField(Object.keys(D.fields)[0]);}
else{ // mesh-preview mode: static per-vertex colors, no scalar bar
 gl.bindBuffer(gl.ARRAY_BUFFER,colB);
 gl.bufferData(gl.ARRAY_BUFFER,new Float32Array(
  D.colors||new Array(nVert*3).fill(0.62)),gl.STATIC_DRAW);
 document.getElementById('bar').style.display='none';
 sel.style.display='none';
}
// camera
let theta=0.7,phi=0.9,dist=2.6*D.radius;
let drag=false,px=0,py=0;
canvas.onmousedown=e=>{drag=true;px=e.clientX;py=e.clientY;};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{if(!drag)return;
 theta+=(e.clientX-px)*0.008;phi=Math.min(3.0,Math.max(0.1,phi+(e.clientY-py)*0.008));
 px=e.clientX;py=e.clientY;draw();};
canvas.onwheel=e=>{e.preventDefault();dist*=Math.exp(e.deltaY*0.001);draw();};
function mat(){const c=D.center;
 const eye=[c[0]+dist*Math.sin(phi)*Math.cos(theta),
            c[1]+dist*Math.cos(phi),
            c[2]+dist*Math.sin(phi)*Math.sin(theta)];
 const f=norm3(sub3(c,eye)),s=norm3(cross3(f,[0,1,0])),u=cross3(s,f);
 const V=[s[0],u[0],-f[0],0, s[1],u[1],-f[1],0, s[2],u[2],-f[2],0,
  -dot3(s,eye),-dot3(u,eye),dot3(f,eye),1];
 const a=canvas.width/canvas.height,n=0.01*D.radius,fa=100*D.radius,
  t=n*Math.tan(0.4);
 const P=[n/(t*a),0,0,0, 0,n/t,0,0, 0,0,-(fa+n)/(fa-n),-1,
  0,0,-2*fa*n/(fa-n),0];
 return mul44(P,V);}
function sub3(a,b){return [a[0]-b[0],a[1]-b[1],a[2]-b[2]];}
function dot3(a,b){return a[0]*b[0]+a[1]*b[1]+a[2]*b[2];}
function cross3(a,b){return [a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],
 a[0]*b[1]-a[1]*b[0]];}
function norm3(a){const l=Math.hypot(a[0],a[1],a[2])||1;
 return [a[0]/l,a[1]/l,a[2]/l];}
function mul44(A,B){const o=new Array(16).fill(0);
 for(let i=0;i<4;i++)for(let j=0;j<4;j++)for(let k=0;k<4;k++)
  o[j*4+i]+=A[k*4+i]*B[j*4+k];return o;}
const warp=document.getElementById('warp');
warp.value=D.factor0;
warp.oninput=()=>{document.getElementById('warpv').textContent=warp.value;draw();};
document.getElementById('warpv').textContent=warp.value;
document.getElementById('title').textContent=D.title;
document.getElementById('legend').textContent=
 (D.legend||[]).concat(D.markers.map(m=>m.label)).join('\n');
function bind(b,l,n){gl.bindBuffer(gl.ARRAY_BUFFER,b);
 gl.enableVertexAttribArray(l);gl.vertexAttribPointer(l,n,gl.FLOAT,false,0,0);}
function draw(){
 canvas.width=innerWidth;canvas.height=innerHeight;
 gl.viewport(0,0,canvas.width,canvas.height);
 gl.enable(gl.DEPTH_TEST);gl.clearColor(0.07,0.07,0.07,1);
 gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 gl.uniformMatrix4fv(loc.mvp,false,new Float32Array(mat()));
 gl.uniform1f(loc.warp,parseFloat(warp.value));
 bind(posB,loc.pos,3);bind(dispB,loc.disp,3);bind(colB,loc.col,3);
 if(nIdx){gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER,idxB);
  gl.drawElements(gl.TRIANGLES,nIdx,gl.UNSIGNED_INT,0);}
 if(nLineIdx){gl.disableVertexAttribArray(loc.col);
  gl.vertexAttrib3f(loc.col,0.08,0.08,0.08);
  gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER,lineIdxB);
  gl.drawElements(gl.LINES,nLineIdx,gl.UNSIGNED_INT,0);
  gl.enableVertexAttribArray(loc.col);}
 if(D.markers.length){bind(mPosB,loc.pos,3);bind(mDispB,loc.disp,3);
  bind(mColB,loc.col,3);gl.drawArrays(gl.POINTS,0,D.markers.length);}
}
window.onresize=draw;
draw();
</script></body></html>
"""
