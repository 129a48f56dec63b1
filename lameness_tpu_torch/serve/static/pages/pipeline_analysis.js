// PipelineAnalysis.tsx (1269 LoC): researcher deep-dive for one video —
// 12 pipeline tabs with status dots (summary/yolo/sam3/dinov3/tleap/tcn/
// transformer/gnn/graph_transformer/ml/fusion/shap), video player with
// frame scrubber + overlay toggles (detections/pose/mask), final
// prediction card, JSON/CSV export. Without a video id the page keeps
// the engine perf view (stage timings + throughput — exceeds reference)
// plus a picker into the deep dive.
import {api, h, main, fmt, pct, esc, short, table, toast,
        sparkline, TOKEN} from "/static/app.js";

const TABS = {
  summary: ["Summary", "Overview of all pipeline results"],
  yolo: ["YOLO", "Object detection (cow bounding boxes)"],
  sam3: ["SAM3", "Instance segmentation masks"],
  dinov3: ["DINOv3", "Visual embeddings & similarity"],
  tleap: ["T-LEAP", "Pose estimation & locomotion"],
  tcn: ["TCN", "Temporal convolutional network"],
  transformer: ["Transformer", "Self-attention gait analysis"],
  gnn: ["GNN", "Graph neural network (GraphGPS)"],
  graph_transformer: ["GraphT", "Graph Transformer (Graphormer)"],
  ml: ["ML Ensemble", "GBDT tabular ensemble"],
  fusion: ["Fusion", "Final ensemble prediction"],
  shap: ["SHAP", "Feature importance & explainability"],
};
// summary-grid pipelines + their headline metric (SummaryTab getMetricDisplay)
const SUMMARY_METRIC = {
  yolo: (d) => [d.features?.num_detections ?? 0, "detections"],
  sam3: (d) => [pct(d.aggregated_features?.avg_area_ratio), "coverage"],
  dinov3: (d) => [(d.similar_cases || []).length, "similar"],
  tleap: (d) => [fmt(d.locomotion_features?.lameness_score, 2), "LS score"],
  tcn: (d) => [fmt(d.severity_score, 2), "severity"],
  transformer: (d) => [fmt(d.severity_score, 2), "severity"],
  gnn: (d) => [fmt(d.severity_score, 2), "severity"],
  graph_transformer: (d) => [fmt(d.graph_prediction, 2), "graph pred"],
  ml: (d) => [fmt(d.predictions?.ensemble?.probability, 2), "prob"],
  fusion: (d) => [fmt(d.fusion_result?.final_probability, 2), "final"],
};

const mc = (label, value, unit = "", hl = false) =>
  `<div class="panel" style="padding:8px${hl ? ";outline:1px solid var(--bad)" : ""}">
    <div class="dim" style="font-size:12px">${label}</div>
    <div style="font-size:17px;font-weight:600${hl ? ";color:var(--bad)" : ""}">
      ${value}<span class="dim" style="font-size:12px"> ${unit}</span></div></div>`;

const mcGrid = (cards) =>
  `<div style="display:grid;grid-template-columns:repeat(auto-fill,minmax(130px,1fr));gap:8px">
    ${cards.join("")}</div>`;

const donut = (v, label) => {
  const C = 2 * Math.PI * 40;
  return `<div style="text-align:center"><svg viewBox="0 0 100 100" width="130"
      style="transform:rotate(-90deg)">
    <circle cx="50" cy="50" r="40" fill="none" stroke="var(--line)" stroke-width="8"/>
    <circle cx="50" cy="50" r="40" fill="none" stroke="${(v ?? 0) > 0.5
      ? "var(--bad)" : "var(--ok)"}" stroke-width="8" stroke-linecap="round"
      stroke-dasharray="${(v ?? 0) * C} ${C}"/></svg>
    <div style="margin-top:-82px;margin-bottom:50px">
      <div style="font-size:22px;font-weight:700">${pct(v)}</div>
      <div class="dim" style="font-size:12px">${label}</div></div></div>`;
};

const nodeBars = (items, valueKey, digits) => items.map(nb =>
  `<div class="row" style="margin-bottom:2px">
    <span class="dim" style="width:100px">${short(nb.video_id, 12)}</span>
    <div class="bar" style="width:110px"><i style="width:${
      Math.min(100, 100 * (nb[valueKey] ?? 0))}%"></i></div>
    <span>${fmt(nb[valueKey], digits)}</span></div>`).join("");

const notAvail = (name) => `<div style="text-align:center;padding:40px"
    class="dim">${esc(name)} results not available<br>
    <span style="font-size:12px">this pipeline may not have processed
    this video yet</span></div>`;

// ---- per-pipeline tab renderers (keys per lameness_tpu/io/schemas.py) ----
const RENDER = {
  summary(all, setTab) {
    const keys = Object.keys(SUMMARY_METRIC);
    const done = keys.filter(k => all[k]);
    const rec = all.fusion?.fusion_result?.recommendation;
    setTimeout(() => keys.forEach(k => {
      const el = document.getElementById(`pa-sum-${k}`);
      if (el) el.onclick = () => setTab(k);
    }));
    return `<h3>Pipeline results <span class="dim">(click a card)</span></h3>
      ${mcGrid(keys.map(k => {
        const d = all[k];
        const [v, l] = d ? SUMMARY_METRIC[k](d) : ["—", "not run"];
        return `<div class="panel click" id="pa-sum-${k}" style="padding:8px;
            cursor:pointer${d ? "" : ";opacity:.55"}">
          <div class="row" style="justify-content:space-between">
            <b style="font-size:13px">${TABS[k][0]}</b>
            <span class="${d ? "ok" : "dim"}">${d ? "●" : "○"}</span></div>
          <div style="font-size:17px;font-weight:600">${v}</div>
          <div class="dim" style="font-size:11px">${l}</div></div>`;
      }))}
      <div class="row" style="margin-top:10px">
        <div class="bar" style="flex:1"><i style="width:${
          100 * done.length / keys.length}%"></i></div>
        <span class="dim">${done.length}/${keys.length} completed</span></div>
      ${rec ? `<div class="panel" style="margin-top:10px">
        <b>Recommendation</b><div class="dim">${esc(rec)}</div></div>` : ""}`;
  },
  yolo(d) {
    if (!d) return notAvail("YOLO");
    const f = d.features || {};
    const sample = (d.detections || []).slice(0, 10);
    return `<h3>Object detection results</h3>
      ${mcGrid([
        mc("Total detections", f.num_detections ?? 0),
        mc("Avg confidence", pct(f.avg_confidence)),
        mc("Max confidence", pct(f.max_confidence)),
        mc("Detection rate", pct(f.detection_rate)),
        mc("Avg box width", fmt(f.avg_box_width, 0), "px"),
        mc("Avg box height", fmt(f.avg_box_height, 0), "px"),
        mc("Position stability", pct(f.position_stability))])}
      ${sample.length ? `<h3 style="margin-top:12px">Sample detections</h3>
        ${table(sample, [
          ["frame", e => e.frame],
          ["count", e => (e.detections || []).length],
          ["avg conf", e => {
            const ds = e.detections || [];
            return ds.length ? pct(ds.reduce((s, x) =>
              s + (x.confidence || 0), 0) / ds.length) : "—";
          }]])}` : ""}`;
  },
  sam3(d) {
    if (!d) return notAvail("SAM3");
    const f = d.aggregated_features || {};
    const segs = d.segmentations || [];
    const withMask = segs.filter(s => s.mask_available).length;
    return `<h3>Segmentation results</h3>
      ${mcGrid([
        mc("Avg area ratio", pct(f.avg_area_ratio)),
        mc("Avg circularity", fmt(f.avg_circularity, 3)),
        mc("Avg aspect ratio", fmt(f.avg_aspect_ratio, 2)),
        mc("Avg mask area", fmt(f.avg_mask_area, 0), "px²")])}
      <div class="dim" style="margin-top:10px">Mask coverage: ${withMask}
        of ${segs.length} frames have masks</div>`;
  },
  dinov3(d) {
    if (!d) return notAvail("DINOv3");
    const sim = (d.similar_cases || []).slice(0, 5);
    return `<h3>Visual embeddings</h3>
      ${mcGrid([
        mc("Embedding dim", d.embedding_dim ?? 768),
        mc("Num embeddings", d.num_embeddings ?? 0),
        mc("Neighbor evidence", pct(d.neighbor_evidence))])}
      ${sim.length ? `<h3 style="margin-top:12px">Similar videos</h3>
        ${table(sim, [
          ["video", s => `<span class="dim">${short(s.video_id, 12)}</span>`],
          ["similarity", s => pct(s.similarity ?? s.score)],
          ["label", s => s.label == null ? "—" : s.label ? "lame" : "sound"]])}`
        : ""}`;
  },
  tleap(d) {
    if (!d) return notAvail("T-LEAP");
    const lf = d.locomotion_features || {};
    return `<h3>Pose estimation &amp; locomotion</h3>
      ${mcGrid([
        mc("Lameness score", fmt(lf.lameness_score, 2), "",
           (lf.lameness_score ?? 0) > 0.5),
        mc("Head bob", fmt(lf.head_bob_magnitude, 3)),
        mc("Back arch", fmt(lf.back_arch_mean, 3)),
        mc("Steadiness", fmt(lf.steadiness_score, 2)),
        mc("Front asymmetry", fmt(lf.front_leg_asymmetry, 3)),
        mc("Rear asymmetry", fmt(lf.rear_leg_asymmetry, 3))])}
      <div class="dim" style="margin-top:10px">
        Frames processed: ${d.frames_processed ?? 0} / ${d.total_frames ?? 0}
        · fps ${d.fps ?? 0} · model <b>${esc(d.model_type || "?")}</b></div>`;
  },
  tcn(d) {
    if (!d) return notAvail("TCN");
    return `<h3>Temporal convolutional network</h3>
      ${donut(d.severity_score, "severity")}
      ${mcGrid([
        mc("Uncertainty", pct(d.uncertainty)),
        mc("Input frames", d.input_frames ?? 0),
        mc("Confidence", pct(d.confidence)),
        mc("Receptive field", d.model_receptive_field ?? "—", "frames")])}`;
  },
  transformer(d) {
    if (!d) return notAvail("Transformer");
    const sal = d.temporal_saliency || [];
    const mi = d.model_info || {};
    return `<h3>Gait transformer</h3>
      ${mcGrid([
        mc("Severity score", fmt(d.severity_score, 3), "",
           (d.severity_score ?? 0) > 0.5),
        mc("Uncertainty", pct(d.uncertainty)),
        mc("Prediction", d.prediction === 1 ? "Lame" : "Healthy"),
        mc("Masked frames", d.masked_frames ?? 0)])}
      ${sal.length ? `<h3 style="margin-top:12px">Temporal saliency</h3>
        <div class="dim" style="font-size:12px">which frames contributed
          most to the prediction</div>${sparkline(sal)}` : ""}
      <div class="dim" style="margin-top:8px">d_model ${mi.d_model ?? "—"} ·
        ${mi.num_layers ?? "—"} layers · ${mi.nhead ?? "—"} heads</div>`;
  },
  gnn(d) {
    if (!d) return notAvail("GNN");
    const gi = d.graph_info || {};
    const nb = (d.neighbor_influence || []).slice(0, 5);
    return `<h3>Graph neural network (GraphGPS)</h3>
      ${mcGrid([
        mc("Severity score", fmt(d.severity_score, 3), "",
           (d.severity_score ?? 0) > 0.5),
        mc("Uncertainty", pct(d.uncertainty)),
        mc("Graph nodes", gi.num_nodes ?? 0),
        mc("Graph edges", gi.num_edges ?? 0),
        mc("kNN", gi.k_neighbors ?? "—"),
        mc("Cow severity", fmt(d.cow_severity_score, 3))])}
      ${nb.length ? `<h3 style="margin-top:12px">Neighbor influence</h3>
        ${nodeBars(nb, "score", 3)}` : ""}`;
  },
  graph_transformer(d) {
    if (!d) return notAvail("Graph Transformer");
    const gi = d.graph_info || {};
    const top = (d.attention_info || {}).top_attending_nodes || [];
    // pl wraps its contents (balanced markup: every template literal
    // must parse as well-formed HTML on its own — tests/test_frontend)
    const pl = (v, label) => `<div class="panel" style="flex:1;
        text-align:center;padding:10px${
        (v ?? 0) > 0.5 ? ";outline:1px solid var(--bad)" : ""}">
        <div class="dim">${label}</div>
        <div style="font-size:22px;font-weight:700">${pct(v)}</div></div>`;
    return `<h3>Graph transformer (Graphormer)</h3>
      <div class="dim" style="margin-bottom:8px">Model:
        <b>${esc(d.model || "CowLamenessGraphormer")}</b></div>
      <div class="row">
        ${pl(d.graph_prediction, "graph-level")}
        ${pl(d.node_prediction, "node-level")}</div>
      ${mcGrid([
        mc("Uncertainty", pct(d.uncertainty)),
        mc("Confidence", pct(d.confidence)),
        mc("Nodes", gi.num_nodes ?? 0),
        mc("Edges", gi.num_edges ?? 0)])}
      <h3 style="margin-top:12px">Architecture</h3>
      <div class="dim">${gi.num_layers ?? 6} layers ·
        ${gi.num_heads ?? 8} heads · hidden dim ${gi.hidden_dim ?? 128}
        ${gi.has_temporal_edges ? "· temporal edges" : ""}</div>
      ${top.length ? `<h3 style="margin-top:12px">Top attending nodes</h3>
        ${nodeBars(top, "attention", 4)}` : ""}`;
  },
  ml(d) {
    if (!d) return notAvail("ML Ensemble");
    const P = d.predictions || {};
    const ens = P.ensemble || {};
    const w = ens.weights || {};
    const fn = d.feature_names || [];
    const fv = d.features || [];
    return `<h3>ML ensemble</h3>
      <div class="panel" style="padding:10px;text-align:center${
        ens.prediction === 1 ? ";outline:1px solid var(--bad)" : ""}">
        <span style="font-size:22px;font-weight:700;color:${
          ens.prediction === 1 ? "var(--bad)" : "var(--ok)"}">${
          ens.prediction === 1 ? "LAME" : "HEALTHY"}</span>
        <span style="font-size:18px;margin-left:12px">${pct(ens.probability)}
        </span></div>
      <h3 style="margin-top:12px">Individual models</h3>
      ${mcGrid(["catboost", "xgboost", "lightgbm"].map(m => P[m]
        ? mc(m, pct(P[m].probability), `w=${fmt(w[m], 2)}`)
        : mc(m, "N/A")))}
      ${fn.length ? `<h3 style="margin-top:12px">Input features
          (${fn.length})</h3>
        ${table(fn.slice(0, 20).map((n, i) => [n, fv[i]]), [
          ["feature", e => esc(e[0])],
          ["value", e => fmt(e[1], 4)]])}` : ""}`;
  },
  fusion(d) {
    if (!d) return notAvail("Fusion");
    const r = d.fusion_result || {};
    const contribs = Object.entries(r.pipeline_contributions || {});
    return `<h3>Fusion service (final decision)</h3>
      <div class="panel" style="text-align:center;padding:16px${
        r.final_prediction === 1 ? ";outline:1px solid var(--bad)" : ""}">
        <div style="font-size:30px;font-weight:700;color:${
          r.final_prediction === 1 ? "var(--bad)" : "var(--ok)"}">${
          r.final_prediction === 1 ? "LAME" : "HEALTHY"}</div>
        <div style="font-size:16px">${pct(r.final_probability)} probability
        </div>
        <div class="dim">confidence ${pct(r.confidence)}</div></div>
      <div class="row" style="margin-top:8px">
        ${mc("Decision mode", esc(r.decision_mode || "hybrid"))}
        ${mc("Model agreement", pct(r.model_agreement))}</div>
      ${contribs.length ? `<h3 style="margin-top:12px">Pipeline contributions
        </h3>${contribs.map(([p, c]) => `<div class="row"
          style="margin-bottom:3px">
        <span class="dim" style="width:90px">${esc(p)}</span>
        <div class="bar" style="flex:1"><i style="width:${
          100 * (c.probability ?? 0)}%;background:${
          (c.probability ?? 0) > 0.5 ? "var(--bad)" : "var(--ok)"}"></i></div>
        <span style="width:48px;text-align:right">${pct(c.probability)}</span>
        <span class="dim" style="width:50px">w:${fmt(c.weight, 2)}</span>
        </div>`).join("")}` : ""}
      ${r.recommendation ? `<div class="panel" style="margin-top:10px">
        <b>Recommendation</b><div class="dim">${esc(r.recommendation)}</div>
        </div>` : ""}`;
  },
  shap(d) {
    if (!d) return notAvail("SHAP");
    const contr = (d.contributions || [])
      .slice().sort((a, b) => Math.abs(b.value) - Math.abs(a.value))
      .slice(0, 10);
    const amax = Math.max(...contr.map(c => Math.abs(c.value)), 1e-9);
    return `<h3>SHAP explainability</h3>
      ${mcGrid([mc("Base value", fmt(d.base_value, 4)),
                mc("Prediction", fmt(d.prediction, 4))])}
      <h3 style="margin-top:12px">Top feature contributions</h3>
      ${contr.map(c => `<div class="row" style="margin-bottom:2px">
        <span class="dim" style="width:130px;overflow:hidden;
          text-overflow:ellipsis">${esc(c.feature)}</span>
        <div style="width:180px;display:flex">
          <div style="width:90px;display:flex;justify-content:flex-end">
            ${c.value < 0 ? `<i style="display:block;height:12px;
              background:var(--ok);width:${90 * Math.abs(c.value) / amax}px">
              </i>` : ""}</div>
          <div style="width:1px;background:var(--line)"></div>
          <div style="width:90px">${c.value > 0 ? `<i style="display:block;
            height:12px;background:var(--bad);width:${
            90 * Math.abs(c.value) / amax}px"></i>` : ""}</div></div>
        <span style="font-size:12px">${fmt(c.value, 4)}</span></div>`)
        .join("")}`;
  },
};

export default async function PipelineAnalysis(videoId) {
  if (!videoId) return perfView();

  const [vinfo, all, shapData] = await Promise.all([
    api(`/api/videos/${videoId}`).catch(() => null),
    api(`/api/analysis/${videoId}/all`),
    api(`/api/shap/${videoId}/force-plot`).catch(() => null)]);
  all.shap = shapData;
  const fps = vinfo?.fps || 15;
  const totalFrames = vinfo?.frame_count || all.yolo?.total_frames ||
    all.tleap?.total_frames || 100;
  const span = Math.max(totalFrames - 1, 1);
  const fr = all.fusion?.fusion_result || {};

  main.append(h(`<div class="panel">
    <h2>Pipeline analysis
      <span class="dim">${short(videoId, 16)}</span>
      <button class="mini" id="pa-back">back</button>
      <button class="mini" id="pa-refresh">refresh</button>
      <button class="mini" id="pa-export-json">export JSON</button>
      <button class="mini" id="pa-export-csv">export CSV</button></h2>
    <div class="row" style="align-items:flex-start;gap:16px">
      <div style="flex:5;min-width:300px">
        <div style="position:relative">
          <video id="pa-video" muted style="width:100%;border-radius:8px"
            src="/api/videos/${videoId}/stream"></video>
          <div id="pa-ov" style="position:absolute;left:0;top:0;width:100%;
            height:100%;pointer-events:none"></div>
          <div id="pa-ov-badge" style="position:absolute;top:6px;left:6px">
          </div></div>
        <div class="row" style="justify-content:center;margin-top:6px">
          <button class="mini" id="pa-b10">⏮ −10</button>
          <button class="mini" id="pa-b1">−1</button>
          <button class="action" id="pa-play" style="padding:4px 14px">▶/⏸
          </button>
          <button class="mini" id="pa-f1">+1</button>
          <button class="mini" id="pa-f10">+10 ⏭</button></div>
        <div class="row" style="margin-top:4px">
          <input type="range" id="pa-range" min="0" max="${span}" value="0"
            style="flex:1">
          <span id="pa-flabel" class="dim">0 / ${span}</span></div>
        <div class="row" style="margin-top:4px;font-size:13px">
          <label><input type="checkbox" id="pa-ov-det" checked> detections
          </label>
          <label><input type="checkbox" id="pa-ov-pose" checked> pose</label>
          <label><input type="checkbox" id="pa-ov-mask"> mask</label></div>
        ${all.fusion ? `<div class="panel" style="margin-top:10px">
          <b>Final prediction</b>
          <div class="row" style="justify-content:space-between">
            <span style="font-size:22px;font-weight:700;color:${
              fr.final_prediction === 1 ? "var(--bad)" : "var(--ok)"}">${
              fr.final_prediction === 1 ? "LAME" : "HEALTHY"}</span>
            <span>${pct(fr.final_probability)}
              <span class="dim">conf ${pct(fr.confidence)}</span></span></div>
          <div class="bar" style="margin-top:4px"><i style="width:${
            100 * (fr.final_probability ?? 0)}%;background:${
            fr.final_prediction === 1 ? "var(--bad)" : "var(--ok)"}"></i>
          </div></div>` : ""}
      </div>
      <div style="flex:7;min-width:340px">
        <div class="row" id="pa-tabs" style="flex-wrap:wrap;gap:4px"></div>
        <div class="dim" id="pa-desc" style="font-size:12px;margin:4px 0">
        </div>
        <div id="pa-content"></div>
      </div></div></div>`));

  // ---- tab bar with status dots ------------------------------------------
  let active = "summary";
  const tabBar = document.getElementById("pa-tabs");
  const content = document.getElementById("pa-content");
  const desc = document.getElementById("pa-desc");
  const setTab = (k) => {
    active = k;
    [...tabBar.children].forEach(b =>
      b.style.outline = b.dataset.k === k ? "2px solid var(--accent)" : "");
    desc.textContent = TABS[k][1];
    content.innerHTML = k === "summary"
      ? RENDER.summary(all, setTab) : RENDER[k](all[k]);
  };
  Object.keys(TABS).forEach(k => {
    const has = k === "summary" || !!all[k];
    // h() returns a wrapper div — append the BUTTON itself, or the
    // data-k click wiring below lands on divs and every click throws
    tabBar.append(h(`<button class="mini" data-k="${k}" title="${TABS[k][1]}">
      ${TABS[k][0]} <span class="${has ? "ok" : "dim"}"
        style="font-size:9px">●</span></button>`).querySelector("button"));
  });
  tabBar.querySelectorAll("button").forEach(
    b => b.onclick = () => setTab(b.dataset.k));
  setTab("summary");

  // ---- header buttons ----------------------------------------------------
  document.getElementById("pa-back").onclick = () => go("videos");
  document.getElementById("pa-refresh").onclick = () =>
    go("pipelineanalysis", videoId);
  const download = async (fmt_) => {
    try {
      const r = await fetch(`/api/analysis/${videoId}/export?format=${fmt_}`,
        {headers: TOKEN ? {Authorization: "Bearer " + TOKEN} : {}});
      const blob = await r.blob();
      const a = document.createElement("a");
      a.href = URL.createObjectURL(blob);
      a.download = `${videoId}_analysis.${fmt_}`;
      a.click();
    } catch (e) { toast(e.message, "bad"); }
  };
  document.getElementById("pa-export-json").onclick = () => download("json");
  document.getElementById("pa-export-csv").onclick = () => download("csv");

  // ---- player + scrubber + overlays --------------------------------------
  const video = document.getElementById("pa-video");
  const ov = document.getElementById("pa-ov");
  const ovBadge = document.getElementById("pa-ov-badge");
  const range = document.getElementById("pa-range");
  const flabel = document.getElementById("pa-flabel");
  const toggles = {
    det: document.getElementById("pa-ov-det"),
    pose: document.getElementById("pa-ov-pose"),
    mask: document.getElementById("pa-ov-mask"),
  };
  const segByFrame = {};
  (all.sam3?.segmentations || []).forEach(s => segByFrame[s.frame] = s);
  let pending = 0;
  const drawFrame = async (n) => {
    const seq = ++pending;
    const fa = await api(`/api/analysis/${videoId}/frames/${n}`)
      .catch(() => null);
    if (seq !== pending) return;
    ov.innerHTML = "";
    ovBadge.innerHTML = "";
    if (!fa) return;
    const W = vinfo?.width || video.videoWidth || 1;
    const H = vinfo?.height || video.videoHeight || 1;
    if (toggles.det.checked) {
      const dets = fa.detections || [];
      if (dets.length) ovBadge.innerHTML = `<span class="badge"
        style="background:var(--warn);color:#000">${dets.length}
        detection${dets.length > 1 ? "s" : ""}</span>`;
      dets.forEach(d => {
        const b = d.bbox || [];
        if (b.length === 4) ov.append(h(`<div style="position:absolute;
          border:2px solid var(--warn);left:${100 * b[0] / W}%;
          top:${100 * b[1] / H}%;width:${100 * (b[2] - b[0]) / W}%;
          height:${100 * (b[3] - b[1]) / H}%"></div>`));
      });
    }
    if (toggles.pose.checked) {
      (((fa.pose || {}).keypoints) || []).forEach(k => {
        if ((k.confidence ?? 0) > 0.2 && k.x != null) ov.append(h(
          `<div style="position:absolute;width:5px;height:5px;
            border-radius:50%;background:var(--ok);
            left:calc(${100 * k.x / W}% - 2px);
            top:calc(${100 * k.y / H}% - 2px)"></div>`));
      });
    }
    if (toggles.mask.checked && segByFrame[n]?.mask_available) {
      ovBadge.append(h(`<span class="badge">mask ✓</span>`));
    }
  };
  let deb;
  const setFrame = (n, seekVideo = true) => {
    n = Math.max(0, Math.min(span, n | 0));
    range.value = n;
    flabel.textContent = `${n} / ${span}`;
    if (seekVideo) { video.pause(); video.currentTime = n / fps; }
    clearTimeout(deb);
    deb = setTimeout(() => drawFrame(n), 120);
  };
  video.ontimeupdate = () => {
    if (!video.paused) setFrame(Math.floor(video.currentTime * fps), false);
  };
  range.oninput = () => setFrame(+range.value);
  document.getElementById("pa-play").onclick = () =>
    video.paused ? video.play() : video.pause();
  document.getElementById("pa-b10").onclick = () => setFrame(+range.value - 10);
  document.getElementById("pa-b1").onclick = () => setFrame(+range.value - 1);
  document.getElementById("pa-f1").onclick = () => setFrame(+range.value + 1);
  document.getElementById("pa-f10").onclick = () => setFrame(+range.value + 10);
  Object.values(toggles).forEach(t => t.onchange = () =>
    drawFrame(+range.value));
  setFrame(0, false);
}

// ---- engine perf view (no video selected) — exceeds reference ------------
async function perfView() {
  const [tp, queue, vids] = await Promise.all([
    api("/api/health/throughput"), api("/api/pipeline/queue"),
    api("/api/videos?limit=50").then(r => r.videos).catch(() => [])]);
  const timings = Object.entries(tp.stage_timings || {});
  const subjects = Object.entries(tp.per_subject || {})
    .sort((a, b) => b[1] - a[1]);
  const smax = Math.max(...subjects.map(s => s[1]), 1);

  main.append(h(`<div class="grid">
    <div class="panel"><div class="dim">messages (window)</div>
      <div class="stat">${tp.messages}</div>
      <div class="dim">${fmt(tp.window_s / 60, 0)} min window</div></div>
    <div class="panel"><div class="dim">videos analyzed</div>
      <div class="stat">${tp.videos_analyzed}</div>
      <div class="dim">${fmt(tp.videos_per_hour, 1)}/hour</div></div>
    <div class="panel"><div class="dim">queue depth</div>
      <div class="stat">${(queue.jobs_by_status || {}).processing || 0}</div>
      <div class="dim">processing jobs</div></div>
  </div>
  <div class="panel"><h2>Deep dive
      <span class="dim">pick an analyzed video for the 12-tab researcher
      view</span></h2><div id="pa-picker"></div></div>
  <div class="panel"><h2>Stage timings
      <span class="dim">(host-side timers around each engine stage)</span></h2>
    <div id="timings"></div></div>
  <div class="panel"><h2>Messages by subject</h2><div id="subj"></div></div>`));

  document.getElementById("pa-picker").innerHTML = vids.length
    ? table(vids.slice(0, 20), [
        ["id", v => `<span class="dim">${short(v.id, 12)}</span>`],
        ["file", v => esc(v.original_filename || v.filename || "")],
        ["status", v => esc(v.status)],
      ], {rowAttr: v =>
        `class="click" onclick="go('pipelineanalysis','${v.id}')"`})
    : `<span class="dim">no videos yet</span>`;

  document.getElementById("timings").innerHTML = timings.length
    ? table(timings, [
        ["stage", t => esc(t[0])],
        ["calls", t => t[1].count],
        ["mean s", t => fmt(t[1].mean_s)],
        ["p50 s", t => fmt(t[1].p50_s)],
        ["max s", t => fmt(t[1].max_s)],
        ["total s", t => fmt(t[1].total_s, 1)]])
    : `<span class="dim">no timings yet — process a video</span>`;

  document.getElementById("subj").innerHTML = subjects.length
    ? subjects.map(([s, n]) => `<div class="row" style="margin-bottom:2px">
        <span class="dim" style="width:210px">${esc(s)}</span>
        <div class="bar" style="width:280px"><i style="width:${
          100 * n / smax}%"></i></div><span>${n}</span></div>`).join("")
    : `<span class="dim">no traffic in the window</span>`;
}
