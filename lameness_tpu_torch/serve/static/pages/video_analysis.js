// VideoAnalysis.tsx + VideoResults drill-down: every pipeline's result for
// one video — fusion gauge, predictor bars, locomotion features, DINO
// neighbors, SHAP force plot, LLM explanation, Elo history, annotation.
import {api, h, main, pct, fmt, esc, short, gauge, sparkline, table, toast,
        sevBadge} from "/static/app.js";

export default async function VideoAnalysis(videoId) {
  if (!videoId) {
    const vids = (await api("/api/videos?limit=100")).videos;
    main.append(h(`<div class="panel"><h2>Pick a video</h2>
      ${vids.length ? table(vids, [
        ["id", v => `<span class="dim">${short(v.id, 12)}</span>`],
        ["file", v => esc(v.original_filename || v.filename || "")],
        ["status", v => esc(v.status)],
      ], {rowAttr: v => `class="click" onclick="go('analysis','${v.id}')"`})
        : '<span class="dim">no videos yet</span>'}</div>`));
    return;
  }
  let a;
  try { a = await api(`/api/analysis/${videoId}`); }
  catch (e) {
    return main.append(h(`<div class="panel">No results yet for
      <b>${esc(videoId)}</b> — still processing?</div>`));
  }
  const vinfo = await api(`/api/videos/${videoId}`).catch(() => null);
  // a.fusion is the INNER fusion_result (reference analysis.py:39-43);
  // tolerate the raw-file shape too
  const fr = (a.fusion || {}).fusion_result || a.fusion || {};
  const contribs = fr.pipeline_contributions || {};
  // collapsible raw-JSON viewer appended to every pipeline card
  // (VideoResults.tsx renders raw JSON for each expanded pipeline)
  const raw = (data) => `<details class="dim"><summary>raw JSON</summary>
    <pre style="max-height:220px">${esc(JSON.stringify(data, null, 1))}
    </pre></details>`;

  main.append(h(`<div class="panel"><h2>Video ${esc(short(videoId, 14))}
    <button class="mini" onclick="go('videos')">back</button></h2>
    <div class="vs">
      <div class="panel">${gauge(fr.final_probability, "fusion")}
        <div>${sevBadge(fr.final_probability)}
          <span class="badge">${esc(fr.decision_mode || "?")}</span></div>
        <div class="dim" style="margin-top:6px">${esc(fr.recommendation || "")}</div>
        <div class="dim">${esc(fr.gate_explanation || "")}</div></div>
      <div class="panel" style="flex:1;text-align:left">
        <h3>Predictor contributions</h3><div id="contrib"></div></div>
      <div class="panel" style="max-width:320px"><video controls
        src="/api/videos/${videoId}/stream" style="max-height:180px"></video>
        <div class="row" style="justify-content:center;margin-top:6px">
          <button class="mini" id="annotate">render skeleton overlay</button>
          <button class="mini" id="retrigger">re-run pipeline</button></div>
        <div id="annotated"></div></div>
    </div></div>
    ${vinfo ? `<div class="panel"><h3>Video info</h3><div class="kv">
      <span class="dim">file</span><b>${esc(vinfo.original_filename
        || vinfo.filename || "—")}</b>
      <span class="dim">size</span><b>${vinfo.file_size ?
        (vinfo.file_size / 1048576).toFixed(2) + " MB" : "—"}</b>
      <span class="dim">duration</span><b>${vinfo.duration ?
        vinfo.duration.toFixed(1) + " s" : "—"}</b>
      <span class="dim">resolution</span><b>${vinfo.width ?
        `${vinfo.width}×${vinfo.height}` : "—"}</b>
      <span class="dim">fps</span><b>${vinfo.fps ?
        (+vinfo.fps).toFixed(1) : "—"}</b>
      <span class="dim">frames</span><b>${vinfo.frame_count ?? "—"}</b>
      <span class="dim">status</span><b>${esc(vinfo.status || "—")}</b>
      <span class="dim">label</span><b id="va-label">${vinfo.label == null
        ? "—" : vinfo.label ? "lame" : "sound"}</b></div>
      <div class="row" style="margin-top:8px">
        <button class="mini ok" id="va-sound">✓ Sound (S)</button>
        <button class="mini bad" id="va-lame">✗ Lame (L)</button>
        <span class="dim">expert label — keyboard: S sound, L lame
        (VideoAnalysis.tsx:76-94)</span></div></div>` : ""}
    <div class="grid3" id="cards"></div>`));

  // -- expert labeling with S/L shortcuts (VideoAnalysis.tsx:57-94) --------
  async function setLabel(label) {
    try {
      await api(`/api/videos/${videoId}/label`, {json: {label}});
      const el = document.getElementById("va-label");
      if (el) el.textContent = label ? "lame" : "sound";
      toast(`labeled ${label ? "lame" : "sound"}`);
    } catch (e) { toast(e.message, "bad"); }
  }
  const vaS = document.getElementById("va-sound");
  const vaL = document.getElementById("va-lame");
  if (vaS) vaS.onclick = () => setLabel(0);
  if (vaL) vaL.onclick = () => setLabel(1);
  const keyHandler = (e) => {
    if (!document.getElementById("va-sound"))
      return window.removeEventListener("keypress", keyHandler);
    if (e.target instanceof HTMLInputElement
        || e.target instanceof HTMLTextAreaElement) return;
    const k = e.key.toLowerCase();
    if (k === "s") setLabel(0);
    else if (k === "l") setLabel(1);
  };
  window.addEventListener("keypress", keyHandler);

  document.getElementById("contrib").innerHTML = Object.keys(contribs).length
    ? table(Object.entries(contribs), [
        ["pipeline", e => esc(e[0])],
        ["p(lame)", e => pct(e[1].probability)],
        ["", e => `<div class="bar" style="width:120px"><i style="width:${
          100 * (e[1].probability ?? 0)}%"></i></div>`],
        ["unc", e => fmt(e[1].uncertainty, 2)],
        ["w", e => fmt(e[1].weight, 2)]])
    : `<span class="dim">no fusion contributions</span>`;

  const cards = document.getElementById("cards");

  // -- yolo ---------------------------------------------------------------
  if (a.yolo) {
    const f = a.yolo.features || {};
    cards.append(h(`<div class="panel"><h2>YOLO detection</h2><div class="kv">
      <span class="dim">detections</span><b>${f.num_detections ?? "—"}</b>
      <span class="dim">avg conf</span><b>${fmt(f.avg_confidence)}</b>
      <span class="dim">detection rate</span><b>${pct(f.detection_rate)}</b>
      <span class="dim">position stability</span><b>${fmt(f.position_stability)}</b>
      <span class="dim">avg box</span><b>${fmt(f.avg_box_width, 0)}×${fmt(f.avg_box_height, 0)}</b>
      </div>${raw(a.yolo)}</div>`));
  }
  // -- sam ----------------------------------------------------------------
  if (a.sam3) {
    const g = a.sam3.aggregated_features || {};
    cards.append(h(`<div class="panel"><h2>SAM segmentation</h2><div class="kv">
      <span class="dim">frames segmented</span><b>${a.sam3.frames_processed ?? "—"}</b>
      <span class="dim">area ratio</span><b>${fmt(g.avg_area_ratio)}</b>
      <span class="dim">circularity</span><b>${fmt(g.avg_circularity)}</b>
      <span class="dim">aspect ratio</span><b>${fmt(g.avg_aspect_ratio)}</b>
      </div>${raw(a.sam3)}</div>`));
  }
  // -- dino ---------------------------------------------------------------
  if (a.dinov3) {
    const sim = a.dinov3.similar_cases || [];
    cards.append(h(`<div class="panel"><h2>DINO embedding</h2>
      <div class="kv"><span class="dim">dim</span><b>${a.dinov3.embedding_dim}</b>
      <span class="dim">neighbor evidence</span>
      <b>${pct(a.dinov3.neighbor_evidence)}</b></div>
      <h3>nearest neighbors</h3>
      ${sim.length ? table(sim, [
        ["video", s => `<span class="dim">${short(s.video_id, 12)}</span>`],
        ["cos", s => fmt(s.similarity)],
        ["label", s => s.label == null ? "—" : s.label ? "lame" : "sound"]])
        : '<span class="dim">no neighbors yet</span>'}${raw(a.dinov3)}</div>`));
  }
  // -- tleap --------------------------------------------------------------
  if (a.tleap) {
    const lf = a.tleap.locomotion_features || {};
    const rows = Object.entries(lf).filter(([k]) => k !== "lameness_score");
    cards.append(h(`<div class="panel"><h2>Pose / locomotion
        <span class="badge">${esc(a.tleap.model_type)}</span></h2>
      <div class="kv"><span class="dim">locomotion score</span>
        <b>${fmt(lf.lameness_score)}</b>
        <span class="dim">frames</span><b>${a.tleap.frames_processed}</b></div>
      ${table(rows, [["feature", e => esc(e[0])],
                     ["value", e => fmt(e[1])]])}${raw(a.tleap)}</div>`));
  }
  // -- predictors ----------------------------------------------------------
  const preds = [
    ["tcn", a.tcn, a.tcn && a.tcn.severity_score],
    ["transformer", a.transformer, a.transformer && a.transformer.severity_score],
    ["gnn", a.gnn, a.gnn && a.gnn.severity_score],
    ["graphormer", a.graph_transformer,
     a.graph_transformer && a.graph_transformer.graph_prediction],
    ["ml ensemble", a.ml, a.ml && a.ml.predictions &&
     (a.ml.predictions.ensemble || {}).probability],
  ].filter(p => p[1]);
  if (preds.length) {
    cards.append(h(`<div class="panel"><h2>Predictors</h2>
      ${table(preds, [
        ["model", p => esc(p[0])],
        ["p(lame)", p => pct(p[2])],
        ["", p => `<div class="bar" style="width:130px"><i style="width:${
          100 * (p[2] ?? 0)}%"></i></div>`],
        ["unc", p => fmt(p[1].uncertainty, 3)]])}</div>`));
  }
  // -- ml ensemble detail (VideoResults.tsx renderMlResults: per-model
  // bars + weights, agreement strip, input feature grid) ------------------
  if (a.ml && a.ml.predictions) {
    const P = a.ml.predictions;
    const ens = P.ensemble || {};
    const w = ens.weights || {};
    const slots = ["catboost", "xgboost", "lightgbm"].filter(s => P[s]);
    const agree = slots.filter(s => P[s].prediction === ens.prediction);
    const fnames = a.ml.feature_names || [];
    const fvals = a.ml.features || [];
    cards.append(h(`<div class="panel"><h2>ML ensemble
        <span class="badge ${ens.prediction === 1 ? 'bad' : 'ok'}">${
          ens.prediction === 1 ? "LAME" : "HEALTHY"}</span></h2>
      <div class="row"><div class="bar" style="flex:1"><i style="width:${
        100 * (ens.probability ?? 0)}%"></i></div>
        <b>${pct(ens.probability)}</b></div>
      ${slots.map(s => `<div class="row" style="margin-top:4px">
        <span class="dim" style="width:72px">${s}</span>
        <div class="bar" style="width:110px"><i style="width:${
          100 * (P[s].probability ?? 0)}%"></i></div>
        <span>${pct(P[s].probability)}</span>
        <span class="dim">w=${fmt(w[s], 2)}</span>
        <span class="${P[s].prediction === ens.prediction ? 'ok' : 'warn'}">${
          P[s].prediction === ens.prediction ? "agrees" : "disagrees"}</span>
        </div>`).join("")}
      <div class="dim" style="margin-top:4px">${agree.length} of
        ${slots.length} models agree with the ensemble</div>
      ${fnames.length ? `<details><summary class="dim">input features
          (${fnames.length})</summary><div class="kv">${
        fnames.map((n, i) => `<span class="dim">${esc(n)}</span>
          <b>${fmt(fvals[i], 4)}</b>`).join("")}</div></details>` : ""}
      ${raw(a.ml)}</div>`));
  }
  // -- tracking -------------------------------------------------------------
  if (a.tracking) {
    const tr = a.tracking;
    cards.append(h(`<div class="panel"><h2>Tracking</h2><div class="kv">
      <span class="dim">tracks</span><b>${tr.total_tracks ?? "—"}</b>
      <span class="dim">cow</span><b>${esc(tr.cow_id || (tr.reid || {}).cow_id || "—")}</b>
      </div>${tr.cow_id || (tr.reid || {}).cow_id ? `<button class="mini"
      onclick="go('cow','${tr.cow_id || tr.reid.cow_id}')">cow detail</button>` : ""}
      </div>`));
  }
  // -- shap ------------------------------------------------------------------
  try {
    const fp = await api(`/api/shap/${videoId}/force-plot`);
    const contr = fp.contributions.slice(0, 8);
    const amax = Math.max(...contr.map(c => Math.abs(c.value)), 1e-9);
    cards.append(h(`<div class="panel"><h2>SHAP</h2>
      <div class="kv"><span class="dim">base</span><b>${fmt(fp.base_value)}</b>
      <span class="dim">prediction</span><b>${fmt(fp.prediction)}</b></div>
      ${contr.map(c => `<div class="row" style="margin-bottom:2px">
        <span class="dim" style="width:110px">${esc(c.feature)}</span>
        <div class="bar" style="width:130px"><i style="width:${
          100 * Math.abs(c.value) / amax}%;background:${
          c.value >= 0 ? "var(--bad)" : "var(--ok)"}"></i></div>
        <span>${fmt(c.value)}</span></div>`).join("")}</div>`));
  } catch (e) {}
  // -- elo history ----------------------------------------------------------
  try {
    const histo = await api(`/api/elo/history/${videoId}`);
    if (histo.length > 1) {
      cards.append(h(`<div class="panel"><h2>Elo history</h2>
        ${sparkline(histo.map(x => x.new_rating))}
        <div class="dim">${histo.length} comparisons</div></div>`));
    }
  } catch (e) {}
  // -- explanation ------------------------------------------------------------
  const exCard = h(`<div class="panel"><h2>LLM explanation</h2>
    <div id="extext" class="dim">not generated</div>
    <button class="mini" id="exgen" style="margin-top:8px">generate</button></div>`);
  cards.append(exCard);
  try {
    const ex = await api(`/api/analysis/${videoId}/explanation/get`);
    exCard.querySelector("#extext").textContent =
      ex.explanation || JSON.stringify(ex);
  } catch (e) {}
  exCard.querySelector("#exgen").onclick = async () => {
    try {
      const ex = await api(`/api/analysis/${videoId}/explanation/generate`,
                           {method: "POST"});
      exCard.querySelector("#extext").textContent =
        ex.explanation || JSON.stringify(ex);
    } catch (e) { toast(e.message, "bad"); }
  };

  // -- availability strip: the full 9-pipeline set with explicit
  // not-available placeholders (VideoResults.tsx pipelineOrder) ------------
  const missing = ["fusion", "yolo", "sam3", "dinov3", "tleap", "tcn",
                   "transformer", "gnn", "ml"].filter(p => !a[p]);
  if (missing.length) {
    cards.append(h(`<div class="panel"><h2>Not yet available</h2>
      ${missing.map(p => `<div class="row">
        <span class="warn">○</span><span class="dim">${p}</span></div>`)
        .join("")}
      <div class="dim">these pipelines have not processed this video</div>
      </div>`));
  }

  document.getElementById("annotate").onclick = async () => {
    toast("rendering…");
    try {
      await api(`/api/videos/${videoId}/annotate`, {method: "POST"});
      document.getElementById("annotated").innerHTML =
        `<video controls src="/api/videos/${videoId}/annotated"
          style="max-height:180px;margin-top:8px"></video>`;
    } catch (e) { toast(e.message, "bad"); }
  };
  document.getElementById("retrigger").onclick = async () => {
    try {
      await api(`/api/pipeline/retrigger/all/${videoId}`, {method: "POST"});
      toast("re-triggered — refresh shortly");
    } catch (e) { toast(e.message, "bad"); }
  };

  // -- frame scrubber (PipelineAnalysis.tsx timeline scrubber: slider +
  // frame stepping + per-frame detections/pose drill-down via
  // /api/analysis/{id}/frames/{n}; detection-density tick marks mirror
  // VideoAnalysis.tsx's timeline detection markers) ------------------------
  const totalFrames = (a.yolo && a.yolo.total_frames) ||
    (a.tleap && a.tleap.total_frames) || 0;
  if (totalFrames > 1) {
    const span = Math.max(totalFrames - 1, 1);
    const detFrames = (a.yolo && a.yolo.detections || [])
      .filter(e => (e.detections || []).length).map(e => e.frame);
    main.append(h(`<div class="panel"><h2>Frame scrubber
        <span class="dim">(${totalFrames} frames)</span></h2>
      <div style="position:relative;display:inline-block;max-width:560px">
        <img id="scrub-img" style="width:100%;display:block" alt="frame">
        <div id="scrub-ov" style="position:absolute;left:0;top:0;width:100%;
          height:100%;pointer-events:none"></div></div>
      <div class="row" style="margin-top:6px">
        <button class="mini" id="scrub-b10">−10</button>
        <button class="mini" id="scrub-b1">−1</button>
        <input type="range" id="scrub-range" min="0" max="${span}" value="0"
          style="flex:1;min-width:220px">
        <button class="mini" id="scrub-f1">+1</button>
        <button class="mini" id="scrub-f10">+10</button>
        <span id="scrub-label" class="dim">frame 0/${span}</span></div>
      <div id="scrub-marks" style="position:relative;height:8px;
          background:rgba(128,128,128,.15);border-radius:3px;margin-top:4px">
        ${detFrames.map(f => `<i style="position:absolute;top:0;width:2px;
          height:8px;background:var(--ok);left:${100 * f / span}%"></i>`)
          .join("")}</div>
      <div id="scrub-info" class="dim" style="margin-top:4px">
        drag the slider to inspect a frame</div></div>`));

    const img = document.getElementById("scrub-img");
    const ov = document.getElementById("scrub-ov");
    const range = document.getElementById("scrub-range");
    const label = document.getElementById("scrub-label");
    const info = document.getElementById("scrub-info");
    let pending = 0;
    const show = async (n) => {
      n = Math.max(0, Math.min(span, n | 0));
      range.value = n;
      label.textContent = `frame ${n}/${span}`;
      const seq = ++pending;
      const loaded = new Promise(res => {
        img.onload = img.onerror = res;
      });
      img.src = `/api/videos/${videoId}/frame?frame=${n}`;
      const [fa] = await Promise.all([
        api(`/api/analysis/${videoId}/frames/${n}`).catch(() => null),
        loaded]);
      if (seq !== pending) return;           // superseded by a later scrub
      ov.innerHTML = "";
      if (!fa) { info.textContent = "no per-frame analysis yet"; return; }
      const W = img.naturalWidth || 1, H = img.naturalHeight || 1;
      (fa.detections || []).forEach(d => {
        const b = d.bbox || [];
        if (b.length === 4) ov.append(h(`<div style="position:absolute;
          border:2px solid var(--warn);left:${100 * b[0] / W}%;
          top:${100 * b[1] / H}%;width:${100 * (b[2] - b[0]) / W}%;
          height:${100 * (b[3] - b[1]) / H}%"><span style="font-size:10px;
          background:var(--warn);color:#000;padding:0 2px">${
            pct(d.confidence)}</span></div>`));
      });
      const kps = ((fa.pose || {}).keypoints) || [];
      kps.forEach(k => {
        if ((k.confidence ?? 0) > 0.2 && k.x != null) ov.append(h(
          `<div style="position:absolute;width:5px;height:5px;
            border-radius:50%;background:var(--ok);
            left:calc(${100 * k.x / W}% - 2px);
            top:calc(${100 * k.y / H}% - 2px)"></div>`));
      });
      info.textContent = `${(fa.detections || []).length} detection(s)` +
        (fa.pose ? `, pose @ frame ${fa.pose.frame} ` +
         `(${kps.length} keypoints)` : ", no pose for this frame");
    };
    let deb;
    range.oninput = () => {
      clearTimeout(deb);
      deb = setTimeout(() => show(+range.value), 150);
    };
    document.getElementById("scrub-b10").onclick = () => show(+range.value - 10);
    document.getElementById("scrub-b1").onclick = () => show(+range.value - 1);
    document.getElementById("scrub-f1").onclick = () => show(+range.value + 1);
    document.getElementById("scrub-f10").onclick = () => show(+range.value + 10);
    show(Math.min(detFrames[0] ?? 0, span));
  }
}
