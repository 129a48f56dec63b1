// TrainingQueue.tsx (257 LoC): labeled-data stat tiles (total/sound/lame/
// balance/readiness), training-status card with gated start button,
// trained-models card with per-model CV metrics, the manual-training
// banner, and the active-learning label queue sorted most-uncertain-first
// — plus our processing-job queue (no reference analog on this page).
import {api, h, main, esc, fmt, pct, short, when, table, toast, USER}
  from "/static/app.js";

export default async function TrainingQueue() {
  const [stats, status, queue, labelq, models] = await Promise.all([
    api("/api/training/stats"), api("/api/training/status"),
    api("/api/training/queue"),
    api("/api/training/label-queue").catch(() => ({videos: [], total: 0})),
    api("/api/training/models").catch(() => ({models: []}))]);
  const privileged = USER && ["admin", "researcher"].includes(USER.role);

  // -- stat tiles (tsx:79-107) ---------------------------------------------
  main.append(h(`<div class="grid">
    <div class="panel"><div class="dim">total labels</div>
      <div class="stat">${stats.total_labels}</div></div>
    <div class="panel"><div class="dim ok">sound</div>
      <div class="stat ok">${stats.sound_count}</div></div>
    <div class="panel"><div class="dim bad">lame</div>
      <div class="stat bad">${stats.lame_count}</div></div>
    <div class="panel"><div class="dim">balance</div>
      <div class="stat">${stats.balance_ratio == null ? "N/A"
        : stats.balance_ratio.toFixed(2)}</div>
      <div class="dim">sound / lame</div></div>
    <div class="panel"><div class="dim">status</div>
      <div class="stat ${stats.ready_for_training ? "ok" : "warn"}"
        style="font-size:20px" id="tq-ready">${stats.ready_for_training
          ? "Ready" : "Need Data"}</div>
      <div class="dim">${stats.pairwise_comparisons} pairwise comparisons</div>
    </div></div>
  <div class="vs">
    <div class="panel" style="flex:1;text-align:left"><h2>Training status</h2>
      <div class="kv" id="tq-status"></div>
      ${privileged ? `<div class="row" style="margin-top:10px">
        <button class="action" id="tq-ml">Start Training</button>
        <button class="ghost" id="tq-yolo">Train YOLO detector</button></div>
        <div class="dim" id="tq-hint" style="margin-top:4px"></div>` : ""}
    </div>
    <div class="panel" style="flex:1;text-align:left"><h2>Trained models</h2>
      <div id="tq-models"></div>
      <div id="tq-metrics"></div></div>
  </div>
  <div class="panel warn" style="border-color:var(--warn)">
    <b>📋 Manual training</b> — click "Start Training" when ready. You need
    at least 10 labeled videos with both Sound and Lame samples. Training
    runs via the bus (training.ml.requested) and fits the GBDT slots plus
    the soft-voting ensemble.</div>
  <div class="panel"><h2>Videos needing labels
      <span class="dim">(${labelq.total} unlabeled, most uncertain
      first)</span></h2><div id="tq-labelq"></div></div>
  <div class="panel"><h2>Processing jobs
      <span class="dim">${Object.entries(queue.by_status || {}).map(([k, v]) =>
        `${esc(k)}: ${v}`).join(" · ")}</span></h2><div id="jobs"></div></div>`));

  // -- status card + start-button gating (tsx:66-71,141-154) ---------------
  function renderStatus(st) {
    const cls = st.status === "completed" ? "ok"
      : st.status === "running" || st.status === "training" ? "warn"
      : st.status === "failed" ? "bad" : "dim";
    document.getElementById("tq-status").innerHTML = `
      <span class="dim">status</span><b class="${cls}">${esc(st.status
        || "idle")}</b>
      <span class="dim">last trained</span><b>${st.completed_at
        ? when(st.completed_at) : "Never"}</b>
      <span class="dim">samples used</span><b>${st.num_labeled
        ?? st.samples_used ?? 0}</b>
      ${st.error ? `<span class="dim">error</span>
        <b class="bad">${esc(st.error)}</b>` : ""}
      ${st.num_skipped_no_features ? `<span class="dim">skipped</span>
        <b>${st.num_skipped_no_features} (no features)</b>` : ""}`;
    const ml = document.getElementById("tq-ml");
    if (ml) {
      const isTraining = st.status === "running" || st.status === "training";
      ml.disabled = !stats.ready_for_training || isTraining;
      ml.textContent = isTraining ? "Training in Progress…"
        : "Start Training";
      document.getElementById("tq-hint").textContent =
        stats.ready_for_training ? ""
          : "Need at least 10 samples with both Sound and Lame labels";
    }
    // per-model CV metrics (tsx:177-196)
    const rep = (st.report || {}).models || st.metrics || {};
    const rows = Object.entries(rep).filter(([, m]) => !m.error);
    document.getElementById("tq-metrics").innerHTML = rows.length
      ? `<h3>Model performance</h3>` + table(rows, [
          ["model", e => esc(e[0])],
          ["CV accuracy", e => e[1].cv_accuracy_mean == null ? "—"
            : `${pct(e[1].cv_accuracy_mean)} ± ${
              pct(e[1].cv_accuracy_std ?? 0)}`]]) : "";
  }
  function renderModels(ms) {
    document.getElementById("tq-models").innerHTML = ms.length
      ? table(ms, [
          ["model", m => esc(m.name)],
          ["size", m => `${fmt(m.size_kb, 1)} KB`],
          ["modified", m => `<span class="dim">${
            new Date(m.modified * 1000).toLocaleString()}</span>`]])
      : `<span class="dim">no models trained yet</span>`;
  }
  renderStatus(status);
  renderModels(models.models || []);

  // -- label queue (tsx:214-254): uncertainty badge at |p-.5| < .2 ---------
  document.getElementById("tq-labelq").innerHTML = labelq.videos.length
    ? table(labelq.videos, [
        ["video", v => `<span class="dim">${short(v.video_id, 12)}</span>`],
        ["predicted", v => `${pct(v.predicted_probability)} lame`],
        ["", v => `<span class="badge ${v.uncertainty < 0.2 ? "warn" : ""}">${
          v.uncertainty < 0.2 ? "Uncertain" : "Confident"}</span>`],
      ], {rowAttr: v =>
        `class="click" onclick="go('analysis','${v.video_id}')"`})
    : `<span class="dim">no unlabeled videos with fusion results —
       upload and analyze videos first</span>`;

  const jobs = (queue.jobs || []).slice(0, 40);
  document.getElementById("jobs").innerHTML = jobs.length ? table(jobs, [
    ["video", j => `<span class="dim">${short(j.video_id, 12)}</span>`],
    ["status", j => `<span class="badge ${j.status === 'completed' ? 'ok'
      : j.status === 'failed' ? 'bad' : ''}">${esc(j.status)}</span>`],
    ["stage", j => esc(j.current_stage || "—")],
    ["created", j => `<span class="dim">${when(j.created_at)}</span>`],
    ["error", j => `<span class="dim">${esc((j.error_message || "").slice(0, 60))}</span>`],
  ]) : `<span class="dim">no jobs yet</span>`;

  const ml = document.getElementById("tq-ml");
  if (ml) ml.onclick = async () => {
    try {
      await api("/api/training/start/ml", {method: "POST"});
      toast("ML training requested");
      setTimeout(refreshStatus, 2000);       // tsx:58
    } catch (e) { toast(e.message, "bad"); }
  };
  const yolo = document.getElementById("tq-yolo");
  if (yolo) yolo.onclick = async () => {
    try {
      await api("/api/training/start/yolo", {method: "POST"});
      toast("YOLO training requested");
    } catch (e) { toast(e.message, "bad"); }
  };

  // -- 10 s status/models repoll (tsx:16) ----------------------------------
  async function refreshStatus() {
    const [st, ms] = await Promise.all([
      api("/api/training/status"),
      api("/api/training/models").catch(() => ({models: []}))]);
    renderStatus(st);
    renderModels(ms.models || []);
  }
  const poll = setInterval(() => {
    if (!document.getElementById("tq-status")) return clearInterval(poll);
    refreshStatus().catch(() => {});
  }, 10000);
}
