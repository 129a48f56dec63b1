// TripletComparison.tsx (396 LoC): reference-anchored odd-one-out flow —
// synced three-player playback, select-then-submit with confidence
// (high/medium/low), keyboard shortcuts (a/1, b/2, space, Enter),
// progress bar, all-complete terminal state.
import {api, h, main, esc, pct, toast} from "/static/app.js";

export default async function TripletComparison() {
  let t;
  try { t = await api("/api/training/triplet/next"); }
  catch (e) {
    return main.append(h(`<div class="panel">${esc(e.message)}
      — need at least three analyzed videos.</div>`));
  }
  const stats = await api("/api/training/triplet/stats");
  if (!t.reference || t.remaining === 0) {
    return main.append(h(`<div class="panel" style="text-align:center;
        padding:40px"><div style="font-size:40px">🎯</div>
      <h2>All triplet tasks complete!</h2>
      <div class="dim">You've answered ${stats.total_triplets} triplets.
      </div>
      <button class="action" onclick="go('pairwise')"
        style="margin-top:10px">go to pairwise comparison</button>
      </div>`));
  }
  const total = stats.total_triplets + t.remaining;
  const q = t.task_type === "similarity"
    ? "Which cow walks MORE SIMILARLY to the reference?"
    : "Which cow walks MORE DIFFERENTLY from the reference?";

  let selected = null;
  let confidence = "medium";
  main.append(h(`<div class="panel"><h2>Triplet comparison
      <span class="dim">${esc(q)}</span></h2>
    <div class="row">
      <div class="bar" style="flex:1"><i style="width:${
        100 * stats.total_triplets / Math.max(total, 1)}%"></i></div>
      <span class="dim">${stats.total_triplets} / ${total}
        (${pct(stats.total_triplets / Math.max(total, 1))})</span></div>
    <div class="row" style="justify-content:center;margin-top:4px">
      <span class="badge">${t.task_type === "similarity"
        ? "🔗 similarity task" : "↔ dissimilarity task"}</span></div>
    <div class="panel" style="text-align:center;margin-top:6px">
      <div class="dim">reference cow</div>
      <video id="tc-ref" muted loop src="/api/videos/${t.reference}/stream"
        style="max-height:200px;outline:2px solid var(--warn)"></video></div>
    <div class="vs">
      <div class="panel" id="tc-card-a" style="cursor:pointer">
        <div class="dim">A — press [a] or [1]</div>
        <video id="tc-a" muted loop src="/api/videos/${t.option_a}/stream">
        </video></div>
      <div style="align-self:center;font-size:24px" class="dim">VS</div>
      <div class="panel" id="tc-card-b" style="cursor:pointer">
        <div class="dim">B — press [b] or [2]</div>
        <video id="tc-b" muted loop src="/api/videos/${t.option_b}/stream">
        </video></div></div>
    <div class="row" style="justify-content:center;margin-top:6px">
      <button class="mini" id="tc-restart">⟲ restart all</button>
      <button class="mini" id="tc-play">▶ / ⏸ all (space)</button></div>
    <div class="row" style="justify-content:center;margin-top:6px"
        id="tc-conf">
      <span class="dim">confidence:</span>
      ${["high", "medium", "low"].map(c => `<button class="mini"
        data-c="${c}">${c}</button>`).join("")}</div>
    <div class="row" style="justify-content:center;margin-top:8px">
      <button class="action" id="tc-submit" disabled>Submit (Enter)</button>
      <button class="mini" id="tc-skip">skip</button></div>
    <div class="panel" style="margin-top:8px;font-size:12px">
      <b>How to compare</b>
      <ul class="dim" style="margin:4px 0 0 16px">
        <li>Watch the <b>reference cow</b> carefully first</li>
        <li>Then compare both A and B to the reference</li>
        <li>${t.task_type === "similarity"
          ? "Select which cow walks most SIMILARLY to the reference"
          : "Select which cow walks most DIFFERENTLY from the reference"}
        </li>
        <li>Consider: gait pattern, speed, posture, lameness indicators</li>
      </ul></div>
    <div class="dim" style="text-align:center;font-size:11px;margin-top:4px">
      shortcuts: <kbd>1/a</kbd> select A · <kbd>2/b</kbd> select B ·
      <kbd>space</kbd> play/pause · <kbd>enter</kbd> submit</div></div>`));

  const videos = ["tc-ref", "tc-a", "tc-b"].map(id =>
    document.getElementById(id));
  const cards = {a: document.getElementById("tc-card-a"),
                 b: document.getElementById("tc-card-b")};
  const submit = document.getElementById("tc-submit");
  const confRow = document.getElementById("tc-conf");

  const select = (c) => {
    selected = c;
    Object.entries(cards).forEach(([k, el]) =>
      el.style.outline = k === c ? "2px solid var(--accent)" : "");
    submit.disabled = false;
  };
  cards.a.onclick = () => select("a");
  cards.b.onclick = () => select("b");
  confRow.querySelectorAll("[data-c]").forEach(b => {
    b.onclick = () => {
      confidence = b.dataset.c;
      confRow.querySelectorAll("[data-c]").forEach(x =>
        x.style.outline = x.dataset.c === confidence
          ? "2px solid var(--accent)" : "");
    };
    if (b.dataset.c === confidence)
      b.style.outline = "2px solid var(--accent)";
  });

  const playAll = () => {
    const anyPaused = videos.some(v => v.paused);
    videos.forEach(v => anyPaused ? v.play() : v.pause());
  };
  const restartAll = () => videos.forEach(v => {
    v.currentTime = 0; v.play();
  });
  document.getElementById("tc-play").onclick = playAll;
  document.getElementById("tc-restart").onclick = restartAll;
  // keep A/B within 0.1 s of the reference (tsx:103-119 sync effect)
  videos[0].ontimeupdate = () => videos.slice(1).forEach(v => {
    if (Math.abs(videos[0].currentTime - v.currentTime) > 0.1)
      v.currentTime = videos[0].currentTime;
  });
  restartAll();

  const doSubmit = async () => {
    if (!selected) return;
    try {
      await api("/api/training/triplet/submit", {json: {
        reference: t.reference, option_a: t.option_a, option_b: t.option_b,
        choice: selected, task_type: t.task_type, confidence}});
      toast("recorded"); go("triplet");
    } catch (e) { toast(e.message, "bad"); }
  };
  submit.onclick = doSubmit;
  document.getElementById("tc-skip").onclick = () => go("triplet");

  document.onkeydown = (e) => {
    if (e.target instanceof HTMLInputElement) return;
    const k = e.key.toLowerCase();
    if (k === "a" || k === "1") select("a");
    else if (k === "b" || k === "2") select("b");
    else if (k === " ") { e.preventDefault(); playAll(); }
    else if (k === "enter") doSubmit();
  };
}
