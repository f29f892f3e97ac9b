"""Interactive scene viewer (apps/Viewer equivalent; a copy of
``openmvs_tpu/viewer_web.py``, the atlas PNG encoded by ``io/png``).

The reference ships a GLFW/GLEW OpenGL viewer (apps/Viewer/Scene.cpp) —
a desktop GL window cannot run in a headless TPU pod, so the interactive
viewer here is a self-contained WebGL page: the scene (point cloud, mesh,
camera frusta) is embedded as base64 typed arrays into one HTML file with a
hand-written WebGL renderer (no external JS dependencies), giving orbit /
pan / zoom, point-size control, layer toggles, click picking (world
coordinates + nearest camera) and screenshot export — the reference
viewer's interactions (Scene.cpp:185-199,702-712) in a shareable file.

  python -m openmvs_tpu_torch view scene.mvs -o scene.html [--serve 8080]
"""

from __future__ import annotations

import base64
import json
import os
from typing import Optional

import numpy as np

from openmvs_tpu_torch.io import png as pngio
from openmvs_tpu_torch.scene import Scene
from openmvs_tpu_torch.utils.log import get_logger

log = get_logger("viewer")


def _b64(arr: np.ndarray) -> str:
    return base64.b64encode(np.ascontiguousarray(arr).tobytes()).decode()


_HTML = """<!DOCTYPE html>
<html><head><meta charset="utf-8"><title>openmvs_tpu viewer</title>
<style>
 body{margin:0;overflow:hidden;background:#111;color:#ddd;font:12px monospace}
 #hud{position:fixed;top:8px;left:8px;background:#000a;padding:8px;border-radius:6px}
 #hud label{display:block;margin:2px 0}
 #info{position:fixed;bottom:8px;left:8px;background:#000a;padding:6px;border-radius:6px}
 button{margin-top:4px}
</style></head>
<body>
<canvas id="c"></canvas>
<div id="hud">
 <b>openmvs_tpu viewer</b><br>
 <label><input type="checkbox" id="showPts" checked> points (PTS_N)</label>
 <label><input type="checkbox" id="showMesh" checked> mesh (MESH_N faces)</label>
 <label id="texRow" style="display:none"><input type="checkbox" id="showTex" checked> textured</label>
 <label><input type="checkbox" id="showCams" checked> cameras (CAM_N)</label>
 <label>point size <input type="range" id="psize" min="1" max="6" value="2"></label>
 <button id="shot">screenshot</button>
 <div>drag: orbit &middot; shift-drag: pan &middot; wheel: zoom &middot; click: pick</div>
</div>
<div id="info">pick a point...</div>
<script>
const DATA = __DATA__;
function decode(b64, T){const s=atob(b64);const u=new Uint8Array(s.length);
 for(let i=0;i<s.length;i++)u[i]=s.charCodeAt(i);return new T(u.buffer);}
const pts = decode(DATA.points, Float32Array);
const cols = DATA.colors ? decode(DATA.colors, Uint8Array) : null;
const meshV = DATA.mesh_v ? decode(DATA.mesh_v, Float32Array) : null;
const meshI = DATA.mesh_i ? decode(DATA.mesh_i, Uint32Array) : null;
const camLines = decode(DATA.cam_lines, Float32Array);
const camCenters = decode(DATA.cam_centers, Float32Array);

const cv = document.getElementById('c');
const gl = cv.getContext('webgl', {preserveDrawingBuffer:true});
gl.getExtension('OES_element_index_uint');
function sh(type, src){const s=gl.createShader(type);gl.shaderSource(s,src);
 gl.compileShader(s);if(!gl.getShaderParameter(s,gl.COMPILE_STATUS))
 throw gl.getShaderInfoLog(s);return s;}
function prog(vs, fs){const p=gl.createProgram();
 gl.attachShader(p,sh(gl.VERTEX_SHADER,vs));
 gl.attachShader(p,sh(gl.FRAGMENT_SHADER,fs));gl.linkProgram(p);return p;}
const VS=`attribute vec3 aP;attribute vec3 aC;uniform mat4 uMVP;
 uniform float uPS;varying vec3 vC;void main(){
 gl_Position=uMVP*vec4(aP,1.0);gl_PointSize=uPS;vC=aC;}`;
const FS=`precision mediump float;varying vec3 vC;uniform float uA;
 void main(){gl_FragColor=vec4(vC,uA);}`;
const P = prog(VS, FS);
const loc={aP:gl.getAttribLocation(P,'aP'),aC:gl.getAttribLocation(P,'aC'),
 uMVP:gl.getUniformLocation(P,'uMVP'),uPS:gl.getUniformLocation(P,'uPS'),
 uA:gl.getUniformLocation(P,'uA')};
// textured-mesh program (atlas pages stacked vertically on export)
const VST=`attribute vec3 aP;attribute vec2 aT;uniform mat4 uMVP;
 varying vec2 vT;void main(){gl_Position=uMVP*vec4(aP,1.0);vT=aT;}`;
const FST=`precision mediump float;varying vec2 vT;uniform sampler2D uTex;
 void main(){gl_FragColor=vec4(texture2D(uTex,vT).rgb,1.0);}`;
let PT=null, locT=null, texObj=null, texPosBuf=null, texUVBuf=null, texN=0;

function buf(data, target){const b=gl.createBuffer();
 gl.bindBuffer(target||gl.ARRAY_BUFFER,b);
 gl.bufferData(target||gl.ARRAY_BUFFER,data,gl.STATIC_DRAW);return b;}
const ptsBuf = buf(pts);
let ptsColBuf=null;
if(cols){const f=new Float32Array(cols.length);
 for(let i=0;i<cols.length;i++)f[i]=cols[i]/255;ptsColBuf=buf(f);}
let meshBuf=null, meshIdx=null, meshColBuf=null, meshN=0;
if(meshV){meshBuf=buf(meshV);meshIdx=buf(meshI,gl.ELEMENT_ARRAY_BUFFER);
 meshN=meshI.length;
 // simple normal-free shading: color by height band
 let mn=1e9,mx=-1e9;for(let i=1;i<meshV.length;i+=3){
  mn=Math.min(mn,meshV[i]);mx=Math.max(mx,meshV[i]);}
 const mc=new Float32Array(meshV.length);
 for(let i=0;i<meshV.length;i+=3){const t=(meshV[i+1]-mn)/(mx-mn+1e-9);
  mc[i]=0.4+0.4*t;mc[i+1]=0.5;mc[i+2]=0.8-0.4*t;}
 meshColBuf=buf(mc);}
if(DATA.tex_png && DATA.tex_v){
 PT=prog(VST,FST);
 locT={aP:gl.getAttribLocation(PT,'aP'),aT:gl.getAttribLocation(PT,'aT'),
  uMVP:gl.getUniformLocation(PT,'uMVP'),uTex:gl.getUniformLocation(PT,'uTex')};
 texPosBuf=buf(decode(DATA.tex_v,Float32Array));
 const uv=decode(DATA.tex_uv,Float32Array);
 texUVBuf=buf(uv);texN=uv.length/2;
 texObj=gl.createTexture();
 const im=new Image();
 im.onload=()=>{gl.bindTexture(gl.TEXTURE_2D,texObj);
  gl.texImage2D(gl.TEXTURE_2D,0,gl.RGB,gl.RGB,gl.UNSIGNED_BYTE,im);
  gl.texParameteri(gl.TEXTURE_2D,gl.TEXTURE_MIN_FILTER,gl.LINEAR);
  gl.texParameteri(gl.TEXTURE_2D,gl.TEXTURE_MAG_FILTER,gl.LINEAR);
  gl.texParameteri(gl.TEXTURE_2D,gl.TEXTURE_WRAP_S,gl.CLAMP_TO_EDGE);
  gl.texParameteri(gl.TEXTURE_2D,gl.TEXTURE_WRAP_T,gl.CLAMP_TO_EDGE);
  requestAnimationFrame(draw);};
 im.src='data:image/png;base64,'+DATA.tex_png;
 document.getElementById('texRow').style.display='block';}
const camBuf = buf(camLines);
const camColor = new Float32Array(camLines.length);
for(let i=0;i<camColor.length;i+=3){camColor[i]=1;camColor[i+1]=0.8;camColor[i+2]=0.1;}
const camColBuf = buf(camColor);

// center/scale over everything visible (points, mesh, cameras) —
// mesh-only scenes have 0 points and must not divide by zero
const geoArrs=[pts];
if(meshV)geoArrs.push(meshV);
if(camCenters.length)geoArrs.push(camCenters);
let cx=0,cy=0,cz=0,n=0;
for(const a of geoArrs)for(let i=0;i<a.length;i+=3){cx+=a[i];cy+=a[i+1];cz+=a[i+2];n++;}
if(n>0){cx/=n;cy/=n;cz/=n;}
let rad=0;
for(const a of geoArrs)for(let i=0;i<a.length;i+=3){const dx=a[i]-cx,dy=a[i+1]-cy,dz=a[i+2]-cz;
 rad=Math.max(rad,Math.sqrt(dx*dx+dy*dy+dz*dz));}
rad=Math.max(rad,1e-3);
let theta=0.5, phi=1.0, dist=rad*2.2, tx=cx, ty=cy, tz=cz;

function mat(){
 const w=cv.width,h=cv.height,a=w/h,f=1/Math.tan(0.4);
 const near=rad*0.01, far=rad*40;
 const eye=[tx+dist*Math.sin(phi)*Math.cos(theta),
            ty+dist*Math.cos(phi),
            tz+dist*Math.sin(phi)*Math.sin(theta)];
 const zax=norm3([eye[0]-tx,eye[1]-ty,eye[2]-tz]);
 const xax=norm3(cross([0,1,0],zax));const yax=cross(zax,xax);
 const V=[xax[0],yax[0],zax[0],0, xax[1],yax[1],zax[1],0,
          xax[2],yax[2],zax[2],0,
          -dot(xax,eye),-dot(yax,eye),-dot(zax,eye),1];
 const Pm=[f/a,0,0,0, 0,f,0,0, 0,0,(far+near)/(near-far),-1,
          0,0,2*far*near/(near-far),0];
 return [mul4(Pm,V), eye];
}
function norm3(v){const l=Math.hypot(v[0],v[1],v[2])||1;return [v[0]/l,v[1]/l,v[2]/l];}
function cross(a,b){return [a[1]*b[2]-a[2]*b[1],a[2]*b[0]-a[0]*b[2],a[0]*b[1]-a[1]*b[0]];}
function dot(a,b){return a[0]*b[0]+a[1]*b[1]+a[2]*b[2];}
function mul4(A,B){const o=new Array(16).fill(0);
 for(let r=0;r<4;r++)for(let c=0;c<4;c++)for(let k=0;k<4;k++)
  o[c*4+r]+=A[k*4+r]*B[c*4+k];return o;}

function draw(){
 cv.width=innerWidth;cv.height=innerHeight;
 gl.viewport(0,0,cv.width,cv.height);
 gl.clearColor(0.07,0.07,0.08,1);gl.enable(gl.DEPTH_TEST);
 gl.clear(gl.COLOR_BUFFER_BIT|gl.DEPTH_BUFFER_BIT);
 gl.useProgram(P);
 const [MVP]=mat();
 gl.uniformMatrix4fv(loc.uMVP,false,new Float32Array(MVP));
 gl.uniform1f(loc.uPS,+document.getElementById('psize').value);
 gl.uniform1f(loc.uA,1.0);
 function attrib(b,l,s){gl.bindBuffer(gl.ARRAY_BUFFER,b);
  gl.enableVertexAttribArray(l);gl.vertexAttribPointer(l,s,gl.FLOAT,false,0,0);}
 const texOn = PT && texObj && document.getElementById('showTex').checked;
 if(document.getElementById('showMesh').checked && texOn){
  gl.useProgram(PT);
  gl.uniformMatrix4fv(locT.uMVP,false,new Float32Array(MVP));
  gl.activeTexture(gl.TEXTURE0);gl.bindTexture(gl.TEXTURE_2D,texObj);
  gl.uniform1i(locT.uTex,0);
  gl.bindBuffer(gl.ARRAY_BUFFER,texPosBuf);
  gl.enableVertexAttribArray(locT.aP);
  gl.vertexAttribPointer(locT.aP,3,gl.FLOAT,false,0,0);
  gl.bindBuffer(gl.ARRAY_BUFFER,texUVBuf);
  gl.enableVertexAttribArray(locT.aT);
  gl.vertexAttribPointer(locT.aT,2,gl.FLOAT,false,0,0);
  gl.drawArrays(gl.TRIANGLES,0,texN);
  gl.useProgram(P);}
 else if(document.getElementById('showMesh').checked && meshBuf){
  attrib(meshBuf,loc.aP,3);attrib(meshColBuf,loc.aC,3);
  gl.bindBuffer(gl.ELEMENT_ARRAY_BUFFER,meshIdx);
  gl.drawElements(gl.TRIANGLES,meshN,gl.UNSIGNED_INT,0);}
 if(document.getElementById('showPts').checked){
  attrib(ptsBuf,loc.aP,3);
  if(ptsColBuf)attrib(ptsColBuf,loc.aC,3);
  else{gl.disableVertexAttribArray(loc.aC);gl.vertexAttrib3f(loc.aC,0.8,0.8,0.8);}
  gl.drawArrays(gl.POINTS,0,pts.length/3);}
 if(document.getElementById('showCams').checked){
  attrib(camBuf,loc.aP,3);attrib(camColBuf,loc.aC,3);
  gl.drawArrays(gl.LINES,0,camLines.length/3);}
}
let drag=false,panning=false,lx=0,ly=0;
cv.onmousedown=e=>{drag=true;panning=e.shiftKey;lx=e.clientX;ly=e.clientY;};
window.onmouseup=()=>drag=false;
window.onmousemove=e=>{if(!drag)return;
 const dx=e.clientX-lx,dy=e.clientY-ly;lx=e.clientX;ly=e.clientY;
 if(panning){const s=dist*0.002;
  tx-=s*(dx*Math.sin(theta)-0);tz+=s*dx*Math.cos(theta);ty+=s*dy;}
 else{theta+=dx*0.008;phi=Math.min(3.0,Math.max(0.15,phi-dy*0.008));}
 requestAnimationFrame(draw);};
cv.onwheel=e=>{dist*=Math.pow(1.1,e.deltaY>0?1:-1);requestAnimationFrame(draw);e.preventDefault();};
cv.onclick=e=>{if(e.shiftKey)return;
 // pick: nearest projected point within 12 px
 const [MVP]=mat();const w=cv.width,h=cv.height;
 const mx=e.clientX, my=e.clientY; let best=-1,bd=12*12;
 const stride=Math.max(1,Math.floor(n/400000));
 for(let i=0;i<n;i+=stride){
  const x=pts[3*i],y=pts[3*i+1],z=pts[3*i+2];
  const cw=MVP[3]*x+MVP[7]*y+MVP[11]*z+MVP[15];
  if(cw<=0)continue;
  const sx=(MVP[0]*x+MVP[4]*y+MVP[8]*z+MVP[12])/cw;
  const sy=(MVP[1]*x+MVP[5]*y+MVP[9]*z+MVP[13])/cw;
  const px=(sx*0.5+0.5)*w, py=(0.5-sy*0.5)*h;
  const d=(px-mx)*(px-mx)+(py-my)*(py-my);
  if(d<bd){bd=d;best=i;}}
 const info=document.getElementById('info');
 if(best>=0){const x=pts[3*best],y=pts[3*best+1],z=pts[3*best+2];
  let bc=-1,bcd=1e30;
  for(let c=0;c<camCenters.length/3;c++){
   const dx=camCenters[3*c]-x,dy=camCenters[3*c+1]-y,dz=camCenters[3*c+2]-z;
   const d=dx*dx+dy*dy+dz*dz;if(d<bcd){bcd=d;bc=c;}}
  info.textContent=`point ${best}: (${x.toFixed(3)}, ${y.toFixed(3)}, ${z.toFixed(3)})`+
   `  nearest camera: ${bc} (${Math.sqrt(bcd).toFixed(2)} away)`;}
 else info.textContent='no point near cursor';
 requestAnimationFrame(draw);};
document.getElementById('shot').onclick=()=>{
 const a=document.createElement('a');a.download='viewer.png';
 a.href=cv.toDataURL('image/png');a.click();};
for(const id of ['showPts','showMesh','showTex','showCams','psize'])
 document.getElementById(id).oninput=()=>requestAnimationFrame(draw);
window.onresize=()=>requestAnimationFrame(draw);
draw();
</script></body></html>
"""


def export_html(scene: Scene, out_path: str, max_points: int = 1_500_000,
                frustum_scale: float = 0.0) -> str:
    """Write a self-contained interactive viewer page for the scene."""
    pc = scene.pointcloud
    pts = np.asarray(pc.points, np.float32).reshape(-1, 3)
    if len(pts) > max_points:
        sel = np.random.default_rng(0).choice(len(pts), max_points, replace=False)
        pts = pts[sel]
        cols = pc.colors[sel] if pc.has_colors else None
    else:
        cols = pc.colors if pc.has_colors else None

    data = {"points": _b64(pts)}
    if cols is not None and len(cols):
        data["colors"] = _b64(np.asarray(cols, np.uint8).reshape(-1, 3))

    mesh = getattr(scene, "mesh", None)
    mesh_faces = 0
    if mesh is not None and len(getattr(mesh, "faces", ())):
        data["mesh_v"] = _b64(np.asarray(mesh.vertices, np.float32))
        data["mesh_i"] = _b64(np.asarray(mesh.faces, np.uint32))
        mesh_faces = len(mesh.faces)
        if mesh.has_texture:
            # textured rendering: atlas pages stacked vertically into one
            # PNG; per-corner positions + UVs (OBJ-style v flipped into the
            # stacked-texture t coordinate: t = (page + 1 - v) / n_pages)
            pages = (mesh.textures if mesh.textures
                     else [mesh.texture])
            n_pg = len(pages)
            atlas = np.concatenate([np.asarray(p, np.uint8) for p in pages],
                                   axis=0)
            while max(atlas.shape[:2]) > 8192:
                atlas = atlas[::2, ::2]
            fp = (np.asarray(mesh.face_page, np.int64)
                  if mesh.face_page is not None
                  else np.zeros(len(mesh.faces), np.int64))
            uv = np.asarray(mesh.face_tex_coords, np.float64).copy()
            t = (fp[:, None] + 1.0 - uv[..., 1]) / n_pg
            uv2 = np.stack([uv[..., 0], t], axis=-1)
            data["tex_v"] = _b64(
                np.asarray(mesh.vertices, np.float32)[
                    mesh.faces.reshape(-1)])
            data["tex_uv"] = _b64(uv2.reshape(-1, 2).astype(np.float32))
            png = pngio.encode(np.ascontiguousarray(atlas))
            data["tex_png"] = base64.b64encode(png).decode()

    # camera frusta as line segments
    centers = []
    lines = []
    if frustum_scale <= 0:
        if len(pts):
            frustum_scale = 0.04 * float(
                np.linalg.norm(pts.max(0) - pts.min(0)) + 1e-9)
        else:
            frustum_scale = 0.2
    for img in scene.images:
        cam = img.camera if img.camera is not None else img.working_camera()
        C = cam.C
        centers.append(C)
        W = img.width or 640
        H = img.height or 480
        corners_px = np.array([[0, 0], [W, 0], [W, H], [0, H]], np.float64)
        rays = (np.concatenate([corners_px, np.ones((4, 1))], 1)
                @ np.linalg.inv(cam.K).T)
        world = C + (rays / np.linalg.norm(rays, axis=1, keepdims=True)
                     ) @ cam.R * frustum_scale
        for k in range(4):
            lines += [C, world[k]]
            lines += [world[k], world[(k + 1) % 4]]
    data["cam_lines"] = _b64(np.asarray(lines, np.float32).reshape(-1, 3)
                             if lines else np.zeros((0, 3), np.float32))
    data["cam_centers"] = _b64(np.asarray(centers, np.float32).reshape(-1, 3)
                               if centers else np.zeros((0, 3), np.float32))

    html = (_HTML
            .replace("__DATA__", json.dumps(data))
            .replace("PTS_N", str(len(pts)))
            .replace("MESH_N", str(mesh_faces))
            .replace("CAM_N", str(len(scene.images))))
    with open(out_path, "w") as f:
        f.write(html)
    log.info("viewer: %s (%d points, %d faces, %d cameras)",
             out_path, len(pts), mesh_faces, len(scene.images))
    return out_path


def serve(path: str, port: int = 8080) -> None:
    """Serve the exported viewer over HTTP (for remote browsers)."""
    import http.server
    import functools

    folder = os.path.dirname(os.path.abspath(path)) or "."
    handler = functools.partial(
        http.server.SimpleHTTPRequestHandler, directory=folder)
    log.info("serving %s at http://0.0.0.0:%d/%s", folder, port,
             os.path.basename(path))
    http.server.HTTPServer(("0.0.0.0", port), handler).serve_forever()
