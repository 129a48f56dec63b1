// SimilarityMap.tsx (914 LoC): interactive embedding map — canvas
// scatter with zoom/pan/hover/click, color by label/cluster/elo,
// labels-only filter, 2-D and 3-D (drag-to-rotate) views, fullscreen,
// cluster centroid labels, and a selected-video detail sidebar.
// Server: /api/analysis/similarity/map (PCA x/y/z + k-means cluster +
// Elo join over the DINO embedding store).
import {api, h, main, esc, short, fmt, table} from "/static/app.js";

const CLUSTER_COLORS = ["#3b82f6", "#f59e0b", "#8b5cf6", "#ec4899", "#14b8a6"];

export default async function SimilarityMap() {
  let data;
  try { data = await api("/api/analysis/similarity/map"); }
  catch (e) {
    return main.append(h(`<div class="panel">${esc(e.message)}
      — analyze at least two videos first.</div>`));
  }
  const pts = data.points;
  // normalise coords to [-0.5, 0.5]³ once; view transforms do the rest
  for (const axis of ["x", "y", "z"]) {
    const vs = pts.map(p => p[axis] ?? 0);
    const lo = Math.min(...vs), hi = Math.max(...vs);
    const span = Math.max(hi - lo, 1e-9);
    for (const p of pts) p[axis] = ((p[axis] ?? 0) - lo) / span - 0.5;
  }

  const W = 760, H = 460;
  main.append(h(`<div class="panel" id="map-panel"><h2>Similarity map
      <span class="dim">${pts.length} videos · PCA of DINO embeddings</span>
      </h2>
    <div class="row" style="flex-wrap:wrap;margin-bottom:6px">
      <label>color by <select id="map-color">
        <option value="label" selected>label</option>
        <option value="cluster">cluster</option>
        <option value="elo">elo</option></select></label>
      <label><input type="checkbox" id="map-labeled"> labeled only</label>
      <button class="mini" id="map-view">3D view</button>
      <button class="mini" id="map-reset">reset view</button>
      <button class="mini" id="map-full">fullscreen</button>
      <span class="dim" id="map-legend"></span></div>
    <div class="row" style="align-items:flex-start">
      <canvas id="map-canvas" width="${W}" height="${H}"
        style="background:var(--bg);border-radius:8px;cursor:grab;
        touch-action:none"></canvas>
      <div id="map-detail" style="min-width:230px;max-width:280px"></div>
    </div>
    <div class="dim">wheel = zoom · drag = ${"pan (2D) / rotate (3D)"} ·
      click = select</div></div>`));

  const canvas = document.getElementById("map-canvas");
  const ctx2 = canvas.getContext("2d");
  const detail = document.getElementById("map-detail");
  const legend = document.getElementById("map-legend");

  const view = {zoom: 1, panX: 0, panY: 0, rotX: -0.5, rotY: 0.6,
                mode: "2d", colorBy: "label", labeledOnly: false,
                hovered: null, selected: null};

  const eloColor = (r) => {
    const t = Math.max(0, Math.min(1, ((r ?? 1500) - 1400) / 200));
    return `rgb(${Math.round(255 * Math.min(1, t * 2))},${
      Math.round(255 * Math.min(1, (1 - t) * 2))},80)`;
  };
  const colorOf = (p) => view.colorBy === "cluster"
    ? CLUSTER_COLORS[p.cluster % CLUSTER_COLORS.length]
    : view.colorBy === "elo" ? eloColor(p.elo_rating)
    : p.label == null ? "#8b96a5" : p.label ? "#e0563f" : "#3fbf7f";

  const shown = () => view.labeledOnly ? pts.filter(p => p.label != null) : pts;

  // 3-D rotation then perspective-free projection to canvas coords
  const project = (p) => {
    let x = p.x, y = p.y, z = p.z || 0;
    if (view.mode === "3d") {
      const cy = Math.cos(view.rotY), sy = Math.sin(view.rotY);
      const cx = Math.cos(view.rotX), sx = Math.sin(view.rotX);
      [x, z] = [x * cy + z * sy, -x * sy + z * cy];
      [y, z] = [y * cx - z * sx, y * sx + z * cx];
    }
    return [W / 2 + (x * W * 0.8) * view.zoom + view.panX,
            H / 2 + (y * H * 0.8) * view.zoom + view.panY, z];
  };

  const draw = () => {
    ctx2.clearRect(0, 0, W, H);
    // light grid (tsx:332-346)
    ctx2.strokeStyle = "rgba(128,128,128,.12)";
    const g = 50 * view.zoom;
    for (let gx = (view.panX % g + g) % g; gx < W; gx += g) {
      ctx2.beginPath(); ctx2.moveTo(gx, 0); ctx2.lineTo(gx, H); ctx2.stroke();
    }
    for (let gy = (view.panY % g + g) % g; gy < H; gy += g) {
      ctx2.beginPath(); ctx2.moveTo(0, gy); ctx2.lineTo(W, gy); ctx2.stroke();
    }
    const ps = shown();
    // depth-sort in 3-D so nearer points draw on top
    const order = ps.map(p => [p, ...project(p)])
      .sort((a, b) => (a[3] || 0) - (b[3] || 0));
    for (const [p, sx, sy, z] of order) {
      const r = (view.mode === "3d" ? 5 + 3 * (z + 0.5) : 6) *
        Math.sqrt(view.zoom) *
        (p === view.selected ? 1.5 : p === view.hovered ? 1.2 : 1);
      ctx2.beginPath();
      ctx2.arc(sx, sy, Math.max(r, 2), 0, 2 * Math.PI);
      ctx2.fillStyle = colorOf(p);
      ctx2.globalAlpha = 0.85;
      ctx2.fill();
      ctx2.globalAlpha = 1;
      if (p === view.selected || p === view.hovered) {
        ctx2.strokeStyle = "#fff"; ctx2.lineWidth = 1.5; ctx2.stroke();
        ctx2.fillStyle = "var(--dim)";
        ctx2.font = "11px monospace";
        ctx2.fillText(p.video_id.slice(0, 8), sx + 8, sy - 8);
      }
    }
    // cluster centroid labels (tsx:381-406)
    if (view.colorBy === "cluster") {
      const by = new Map();
      for (const p of ps) {
        if (!by.has(p.cluster)) by.set(p.cluster, []);
        by.get(p.cluster).push(p);
      }
      ctx2.font = "bold 12px sans-serif";
      for (const [c, members] of by) {
        const cx = members.reduce((s, p) => s + project(p)[0], 0) / members.length;
        const cy = members.reduce((s, p) => s + project(p)[1], 0) / members.length;
        ctx2.fillStyle = CLUSTER_COLORS[c % CLUSTER_COLORS.length];
        ctx2.fillText(`cluster ${c} (${members.length})`, cx - 30, cy);
      }
    }
    legend.textContent = view.colorBy === "label"
      ? "red = lame · green = sound · grey = unlabeled"
      : view.colorBy === "elo" ? "red = high Elo (more lame) · green = low"
      : `${new Set(ps.map(p => p.cluster)).size} k-means clusters`;
  };

  const pick = (mx, my) => {
    let best = null, bestD = 12 * 12;
    for (const p of shown()) {
      const [sx, sy] = project(p);
      const d = (mx - sx) ** 2 + (my - sy) ** 2;
      if (d < bestD) { bestD = d; best = p; }
    }
    return best;
  };

  let drag = null;
  canvas.onmousedown = (e) => {
    drag = {x: e.offsetX, y: e.offsetY, panX: view.panX, panY: view.panY,
            rotX: view.rotX, rotY: view.rotY, moved: false};
    canvas.style.cursor = "grabbing";
  };
  canvas.onmousemove = (e) => {
    if (drag) {
      const dx = e.offsetX - drag.x, dy = e.offsetY - drag.y;
      if (Math.abs(dx) + Math.abs(dy) > 3) drag.moved = true;
      if (view.mode === "3d") {
        view.rotY = drag.rotY + dx * 0.01;
        view.rotX = drag.rotX + dy * 0.01;
      } else {
        view.panX = drag.panX + dx;
        view.panY = drag.panY + dy;
      }
    } else {
      view.hovered = pick(e.offsetX, e.offsetY);
      canvas.style.cursor = view.hovered ? "pointer" : "grab";
    }
    draw();
  };
  canvas.onmouseup = (e) => {
    const wasClick = drag && !drag.moved;
    drag = null;
    canvas.style.cursor = "grab";
    if (wasClick) {
      view.selected = pick(e.offsetX, e.offsetY);
      draw();
      renderDetail();
    }
  };
  canvas.onwheel = (e) => {
    e.preventDefault();
    view.zoom = Math.max(0.3, Math.min(8, view.zoom *
      (e.deltaY > 0 ? 0.9 : 1.1)));
    draw();
  };

  document.getElementById("map-color").onchange = (e) => {
    view.colorBy = e.target.value; draw();
  };
  document.getElementById("map-labeled").onchange = (e) => {
    view.labeledOnly = e.target.checked; draw();
  };
  document.getElementById("map-view").onclick = (e) => {
    view.mode = view.mode === "2d" ? "3d" : "2d";
    e.target.textContent = view.mode === "2d" ? "3D view" : "2D view";
    draw();
  };
  document.getElementById("map-reset").onclick = () => {
    Object.assign(view, {zoom: 1, panX: 0, panY: 0, rotX: -0.5, rotY: 0.6});
    draw();
  };
  document.getElementById("map-full").onclick = () => {
    const panel = document.getElementById("map-panel");
    if (document.fullscreenElement) document.exitFullscreen();
    else panel.requestFullscreen && panel.requestFullscreen();
  };

  // selected-video sidebar (tsx:828-899): player, label/cluster/elo,
  // same-cluster members, DINO nearest neighbors, open-analysis
  async function renderDetail() {
    const p = view.selected;
    if (!p) { detail.innerHTML = ""; return; }
    const mates = pts.filter(q => q.cluster === p.cluster &&
                             q.video_id !== p.video_id).slice(0, 6);
    detail.innerHTML = `<div class="panel"><h3>${esc(short(p.video_id, 14))}
        <button class="mini" onclick="go('analysis','${p.video_id}')">
          analysis</button></h3>
      <video controls muted loop style="width:100%"
        src="/api/videos/${p.video_id}/stream"></video>
      <div class="kv">
        <span class="dim">label</span><b>${p.label == null ? "? unknown"
          : p.label ? "✗ lame" : "✓ healthy"}</b>
        <span class="dim">cluster</span><b style="color:${
          CLUSTER_COLORS[p.cluster % CLUSTER_COLORS.length]}">${p.cluster}</b>
        <span class="dim">elo</span><b>${fmt(p.elo_rating, 0) || "—"}</b></div>
      ${mates.length ? `<h3>same cluster</h3>${mates.map(q =>
        `<div class="row click" onclick="go('analysis','${q.video_id}')">
          <span class="dim">${short(q.video_id, 14)}</span></div>`).join("")}`
        : ""}
      <div id="map-nn"><span class="dim">loading neighbors…</span></div></div>`;
    try {
      const d = await api(`/api/analysis/${p.video_id}/dinov3`);
      const sim = d.similar_cases || [];
      document.getElementById("map-nn").innerHTML = sim.length
        ? `<h3>nearest neighbors</h3>` + table(sim.slice(0, 6), [
            ["video", s => `<span class="dim">${short(s.video_id, 12)}</span>`],
            ["cos", s => fmt(s.similarity)],
            ["label", s => s.label == null ? "—" : s.label ? "lame" : "sound"]])
        : `<span class="dim">no stored neighbors</span>`;
    } catch (e) {
      document.getElementById("map-nn").textContent = "";
    }
  }

  draw();
}
